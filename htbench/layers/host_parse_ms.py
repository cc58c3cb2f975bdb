"""Codestream parse, ms per frame: marker parse and the native T2 parse
(span ``host_parse``: ``decoder.parse_codestream``,
``fastpath.parse_frame_flat``)."""

SPANS = ("host_parse",)


def read(t):
    return t.span_ms_per_frame("host_parse")
