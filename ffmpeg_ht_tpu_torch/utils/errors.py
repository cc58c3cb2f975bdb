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


class PatchWelcome(J2KError):
    """Valid codestream using an unsupported feature (AVERROR_PATCHWELCOME)."""


class UnshardableBatch(J2KError):
    """decode_batch(devices=, require_shard=True) could not shard the batch.

    The message names the first stream/feature that left the sharded (v3)
    profile. Without require_shard the same condition is a logged warning
    plus single-device decode.
    """
