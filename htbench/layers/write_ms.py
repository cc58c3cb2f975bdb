"""Frame write, ms per frame, from the program's own span ``write``:
``Decoder._split_frames``, the output split into frames and written in
the negotiated pixel format; the scope of ``host_write_ms``."""

from .. import program_trace

__getattr__ = program_trace.hook


def read(t):
    return program_trace.span_ms_per_frame(t, "write")
