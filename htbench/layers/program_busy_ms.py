"""The device program, ms per frame: the union of the device operations
in the traced window that are not copies between host and device
(kernels, fills, copies on the card), over the frames decoded."""


def read(t):
    busy = t.busy_s(program_only=True)
    if busy is None or t.frames == 0:
        return None
    return 1e3 * busy / t.frames
