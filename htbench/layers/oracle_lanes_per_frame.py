"""Codeblocks the scalar oracle decodes on the host, per frame: the
growth over the window of the program's counter ``oracle_lanes``
(long-tail codeblocks, those with more than 25 magnitude bitplanes, and
on the v2 routes the small ones)."""

from .. import program_trace

__getattr__ = program_trace.hook


def read(t):
    w = program_trace.window(t)
    if w is None or t.frames == 0:
        return None
    return w.counters.get("oracle_lanes", 0) / t.frames
