"""CUDA kernel launches per frame: the growth over the window of the
program's launch counters (``trace.launches()``, the sum of the kernel
wrappers' ``.launches``), over the frames returned."""

from .. import program_trace

__getattr__ = program_trace.hook


def read(t):
    w = program_trace.window(t)
    if w is None or t.frames == 0:
        return None
    return w.launches / t.frames
