"""Codestream parse, ms per frame, from the program's own span ``parse``:
``Decoder._parse`` (marker parse) and ``fastpath.parse_frame_flat`` (the
native T2 parse); the scope of ``host_parse_ms``."""

from .. import program_trace

__getattr__ = program_trace.hook


def read(t):
    return program_trace.span_ms_per_frame(t, "parse")
