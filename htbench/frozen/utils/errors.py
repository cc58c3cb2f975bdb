"""Error types mirroring the reference decoder's failure taxonomy.

The reference returns AVERROR_INVALIDDATA for malformed codestreams and
AVERROR_PATCHWELCOME for valid-but-unsupported features (e.g.
libavcodec/jpeg2000dec.c:208-267). We use typed exceptions; the host parser
validates identically and never ships bad data to device kernels.
"""


class J2KError(Exception):
    """Base class for codec errors."""


class InvalidData(J2KError):
    """Malformed codestream (reference: AVERROR_INVALIDDATA)."""


