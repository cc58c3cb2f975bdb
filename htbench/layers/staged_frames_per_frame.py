"""Frames staged for the device in one copy, per frame returned: the
growth over the window of the program's counter ``staged_frames``
(counted where ``fastpath.Staging.upload`` sends a v3 program call's
arguments, written into one buffer, to the device in one copy), over the
frames returned. 1.0 where every frame's arguments go up that way; None
where the program has no such counter."""

from .. import program_trace

__getattr__ = program_trace.hook


def read(t):
    w = program_trace.window(t)
    if w is None or t.frames == 0 or "staged_frames" not in w.counters:
        return None
    return w.counters["staged_frames"] / t.frames
