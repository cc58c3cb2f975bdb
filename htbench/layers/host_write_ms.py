"""Frame write, ms per frame: the packed output split into frames and
written in the negotiated pixel format (span ``host_write``:
``Decoder._split_frames``)."""

SPANS = ("host_write",)


def read(t):
    return t.span_ms_per_frame("host_write")
