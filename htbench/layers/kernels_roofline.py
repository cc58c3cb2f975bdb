"""The device program's share of its roofline, %.

The least time the card could take is the frame's compulsory bytes over
its memory bandwidth: the codestream bytes handed in and the output
frame's bytes (height x width x components x bytes a sample of the
negotiated format), both from the benchmark's own inputs, so the count
reads the same work whatever implements the kernels. The share is that
time over the program's busy time (``program_busy_ms``); the program
has to read its input and write its output, so it cannot pass 100%.
"""


def read(t):
    busy = t.busy_s(program_only=True)
    if busy is None or not t.hbm_bytes_per_s:
        return None
    bound_s = (t.stream_bytes + t.output_bytes) / t.hbm_bytes_per_s
    return 100.0 * bound_s / busy
