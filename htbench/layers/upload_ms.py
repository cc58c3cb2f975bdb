"""Upload, ms per frame, from the program's own span ``upload``: each
``fastpath.to_torch`` of a program's arguments (the page-locked staging
and the queued copy; the copy itself runs on the device)."""

from .. import program_trace

__getattr__ = program_trace.hook


def read(t):
    return program_trace.span_ms_per_frame(t, "upload")
