"""Frames per second: every frame handed in during the window, all
returned and counted, over the time from the first frame handed in to
the last returned. No call starts after the window's length has
passed; the calls in flight then run to their end."""


def read(w):
    if not w.t_out or w.t_end <= w.t0:
        return None
    return len(w.t_out) / (w.t_end - w.t0)
