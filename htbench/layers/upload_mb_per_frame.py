"""Bytes uploaded in staged copies, MB (1e6 bytes) per frame returned:
the growth over the window of the program's counter ``staged_bytes``
(the size of each buffer ``fastpath.Staging.upload`` copies to the
device: a v3 program call's arguments, the pow2-padded word streams
most of it), over the frames returned. None where the program has no
such counter."""

from .. import program_trace

__getattr__ = program_trace.hook


def read(t):
    w = program_trace.window(t)
    if w is None or t.frames == 0 or "staged_bytes" not in w.counters:
        return None
    return w.counters["staged_bytes"] / t.frames / 1e6
