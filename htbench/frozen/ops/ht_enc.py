"""HT (High-Throughput, Rec. ITU-T T.814) block encoder — cleanup pass.

The port's encoder there codes a block in ``native/htenc.c`` and falls
back to Python; this copy keeps the native coder and the tables that
``utils/native.py`` hands it, so a failed native encode raises.

The encoder emits a single cleanup pass (z_blk = 1) carrying all magnitude
bitplanes: MEL run-length coding of quad significance, CxtVLC significance/
EMB patterns, U-VLC exponent offsets and a MagSgn magnitude/sign stream,
assembled per T.814 7.2/7.3 (stream layout as consumed by
jpeg2000htdec.c:1188-1336).

Interop constraint: the reference discards samples coded with m_n == 0
(recover_mag_sgn, jpeg2000htdec.c:419-426 skips mu when m_n == 0), so the
encoder keeps m_n >= 1 for every significant sample by bounding U_q >= 2
and only using EMB entries consistent with that.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from htbench.frozen.ops import tables as tb
from htbench.frozen.utils.errors import InvalidData


# ---------------------------------------------------------------------------
# inverse CxtVLC tables
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _inverse_cxtvlc(table_idx: int):
    """(ctx, res_off, sig_pat, emb_k, emb_1) -> (codeword, length)."""
    inv = {}
    for ctx in range(8):
        for code in range(128):
            packed = int(tb.CXTVLC_PACKED[table_idx, code + (ctx << 7)])
            if packed == 0:
                continue
            length = (packed & 0xF) >> 1
            if length == 0 or length > 7:
                continue
            cwd = code & ((1 << length) - 1)
            key = (ctx, packed & 1, (packed >> 4) & 0xF,
                   (packed >> 8) & 0xF, (packed >> 12) & 0xF)
            if key not in inv:
                inv[key] = (cwd, length)
    return inv


# ---------------------------------------------------------------------------
# U-VLC prefix codes
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _uvlc_prefix_codes():
    """prefix value -> (bits, nbits), derived by inverting the decoder LUT."""
    codes = {}
    for bits in range(8):
        val = int(tb.UVLC_PREFIX_VALUE[bits])
        drop = int(tb.UVLC_PREFIX_DROP[bits])
        key = val
        if key not in codes:
            codes[key] = (bits & ((1 << drop) - 1), drop)
    return codes


# ---------------------------------------------------------------------------
# cleanup-segment encoder
# ---------------------------------------------------------------------------


def encode_cleanup(mag: np.ndarray, sign: np.ndarray, zbp: int):
    """Encode one code-block's cleanup segment.

    `mag` (h, w) non-negative quantized magnitudes, `sign` (h, w) 0/1.
    Returns the Dcup byte string (MagSgn || MEL || reversed VLC || Scup
    trailer) and Lcup. The caller signals `zbp` zero bitplanes via the
    packet header; the decoder's U bound is maxbp = zbp + 1 (parity:
    jpeg2000htdec.c:605,1263).
    """
    from htbench.frozen.utils import native
    res = native.ht_encode_cleanup(np.asarray(mag), np.asarray(sign), zbp)
    if res is None:
        raise InvalidData(f"native cleanup encode failed (zbp {zbp})")
    return res
