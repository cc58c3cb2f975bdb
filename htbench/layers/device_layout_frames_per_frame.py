"""Frames handed out in the program's frame layout, per frame returned:
the growth over the window of the program's counter
``device_layout_frames`` (counted where ``Decoder._split_frames`` copies
a frame's planes out of the fetched buffer), over the frames returned.
1.0 where the program writes every frame in its pixel format's layout;
None where the program has no such counter."""

from .. import program_trace

__getattr__ = program_trace.hook


def read(t):
    w = program_trace.window(t)
    if w is None or t.frames == 0 or "device_layout_frames" not in w.counters:
        return None
    return w.counters["device_layout_frames"] / t.frames
