"""Lane build, ms per frame: a frame's lane columns, stream prep into the
program's arrays and their upload (span ``host_lane``:
``fastpath.build_v3_frame``, ``decoder.finish_v3_numpy``,
``decoder.to_torch``)."""

SPANS = ("host_lane",)


def read(t):
    return t.span_ms_per_frame("host_lane")
