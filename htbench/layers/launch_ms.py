"""Program call, ms per frame, from the program's own span ``launch``:
the host side of ``V3Program.__call__`` / ``BucketProgram.__call__``,
argument checks and kernel launches (no device sync)."""

from .. import program_trace

__getattr__ = program_trace.hook


def read(t):
    return program_trace.span_ms_per_frame(t, "launch")
