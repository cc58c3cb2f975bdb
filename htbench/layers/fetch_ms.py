"""Fetch wait, ms per frame, from the program's own span ``fetch``: the
wait on the event behind the output's copy to the host (the callable
``Decoder._start_fetch`` returns)."""

from .. import program_trace

__getattr__ = program_trace.hook


def read(t):
    return program_trace.span_ms_per_frame(t, "fetch")
