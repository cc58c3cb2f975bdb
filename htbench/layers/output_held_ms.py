"""Output held, ms per frame: for each entry call, the time from the end
of its ``dispatch`` span to the start of its ``finish`` span (the output
queued or ready, waiting for the caller to come back to it: in
``decode_stream``, the frames dispatched ahead of it), summed over the
calls of the window, over the frames returned."""

from .. import program_trace

__getattr__ = program_trace.hook


def read(t):
    w = program_trace.window(t)
    if w is None or t.frames == 0:
        return None
    dispatched, held = {}, 0.0
    for name, s, e, call, _parent in w.spans:
        if name == "dispatch":
            dispatched[call] = e
        elif name == "finish" and call in dispatched:
            held += s - dispatched.pop(call)
    return 1e3 * held / t.frames
