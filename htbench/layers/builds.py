"""Builds inside the window: the growth of the program's counter
``builds`` (a ``FlatGeometry``, an assembly plan, a ``V3Program`` or a
``BucketProgram`` made on a cache miss); 0 once warm-up has built what
the cell runs."""

from .. import program_trace

__getattr__ = program_trace.hook


def read(t):
    w = program_trace.window(t)
    if w is None:
        return None
    return w.counters.get("builds", 0)
