"""Frames dispatched on the float 9/7, per frame returned: the growth
over the window of the program's counter ``float97_frames`` (counted
where the decoder dispatches a float 9/7 frame to either program), over
the frames returned. 1.0 where every frame of a float 9/7 configuration
takes that route; None where the program has no such counter."""

from .. import program_trace

__getattr__ = program_trace.hook


def read(t):
    w = program_trace.window(t)
    if w is None or t.frames == 0 or "float97_frames" not in w.counters:
        return None
    return w.counters["float97_frames"] / t.frames
