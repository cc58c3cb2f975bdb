"""Lane arguments, ms per frame, from the program's own span
``lane_args``: ``fastpath.finish_v3_numpy`` (v2: ``finish_buckets``),
the frames' byte matrices stacked and the native stream prep."""

from .. import program_trace

__getattr__ = program_trace.hook


def read(t):
    return program_trace.span_ms_per_frame(t, "lane_args")
