"""Lane columns, ms per frame, from the program's own span ``lane_cols``:
``fastpath.build_v3_frame`` (v2: ``build_bucket_args``; the object
path: ``_build_batch``), the scalar oracle's host lanes included (span
``oracle``, its child)."""

from .. import program_trace

__getattr__ = program_trace.hook


def read(t):
    return program_trace.span_ms_per_frame(t, "lane_cols")
