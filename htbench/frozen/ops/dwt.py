"""Forward discrete wavelet transforms (5/3, 9/7 int) of the encoder.

Vectorized NumPy implementation with exact behavior parity against
jpeg2000dwt.c:77-307 (encode): identical lifting order, integer rounding
(incl. the ALPHA' = alpha-1 split and I_PRESHIFT scaling) and symmetric
edge extension. Each lifting sweep writes one parity and reads only the
other, so whole-line batches vectorize without changing results.
"""

from __future__ import annotations

import numpy as np

I_PRESHIFT = 8

I_LFTG_ALPHA_PRIME = 38413  # = 103949 - 65536 (alpha - 1.0 in Q16)
I_LFTG_BETA = 3472
I_LFTG_GAMMA = 57862
I_LFTG_DELTA = 29066
I_LFTG_K = 80621
I_LFTG_X = 53274

DWT97 = 0
DWT53 = 1
DWT97_INT = 2

_PAD = 8  # line padding on each side, covers the 4-sample 9/7 extension


def dwt_levels(border, ndeclevels: int):
    """Per-level (linelen, mod) from component borders (jpeg2000dwt.c:539-560)."""
    b = [[border[0][0], border[0][1]], [border[1][0], border[1][1]]]
    linelen = [[0, 0] for _ in range(ndeclevels)]
    mod = [[0, 0] for _ in range(ndeclevels)]
    for lev in range(ndeclevels - 1, -1, -1):
        for i in range(2):
            linelen[lev][i] = b[i][1] - b[i][0]
            mod[lev][i] = b[i][0] & 1
            b[i][0] = (b[i][0] + 1) >> 1
            b[i][1] = (b[i][1] + 1) >> 1
    return linelen, mod


def _extend(p: np.ndarray, i0: int, i1: int, reach: int) -> None:
    """Symmetric extension: reach=2 for 5/3, 4 for 9/7 (jpeg2000dwt.c:49-75)."""
    base = _PAD
    if reach == 2:
        p[:, base + i0 - 1] = p[:, base + i0 + 1]
        p[:, base + i1] = p[:, base + i1 - 2]
        p[:, base + i0 - 2] = p[:, base + i0 + 2]
        p[:, base + i1 + 1] = p[:, base + i1 - 3]
    else:
        for i in range(1, 5):
            p[:, base + i0 - i] = p[:, base + i0 + i]
            p[:, base + i1 + i - 1] = p[:, base + i1 - i - 1]


def _idx(p: np.ndarray, lo: int, hi: int, step: int = 2) -> np.ndarray:
    """View of positions lo, lo+2, ..., < hi (line coords, padded buffer)."""
    return p[:, _PAD + lo:_PAD + hi:step]


def _sd_1d53(p: np.ndarray, i0: int, i1: int) -> None:
    """Batched forward 5/3 lifting (sd_1d53, jpeg2000dwt.c:77-93)."""
    if i1 <= i0 + 1:
        if i0 == 1:
            p[:, _PAD + 1] *= 2
        return
    _extend(p, i0, i1, 2)
    a, b = ((i0 + 1) >> 1) - 1, (i1 + 1) >> 1
    od = _idx(p, 2 * a + 1, 2 * b + 1)
    od -= (_idx(p, 2 * a, 2 * b) + _idx(p, 2 * a + 2, 2 * b + 2)) >> 1
    a, b = (i0 + 1) >> 1, (i1 + 1) >> 1
    ev = _idx(p, 2 * a, 2 * b)
    ev += (_idx(p, 2 * a - 1, 2 * b - 1) + _idx(p, 2 * a + 1, 2 * b + 1) + 2) >> 2


def _q16(coef: int, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """(coef * (x + y) + 2^15) >> 16 in int64, truncated to int32."""
    s = x.astype(np.int64) + y.astype(np.int64)
    return ((coef * s + (1 << 15)) >> 16).astype(np.int32)


def _sd_1d97_int(p: np.ndarray, i0: int, i1: int) -> None:
    """Batched forward 9/7 int lifting (sd_1d97_int, jpeg2000dwt.c:221-247)."""
    if i1 <= i0 + 1:
        if i0 == 1:
            p[:, _PAD + 1] = ((p[:, _PAD + 1].astype(np.int64) * I_LFTG_X
                               + (1 << 14)) >> 15).astype(np.int32)
        else:
            p[:, _PAD + 0] = ((p[:, _PAD + 0].astype(np.int64) * I_LFTG_K
                               + (1 << 15)) >> 16).astype(np.int32)
        return
    _extend(p, i0, i1, 4)
    i0 += 1
    i1 += 1
    a, b = (i0 >> 1) - 2, (i1 >> 1) + 1
    s = (_idx(p, 2 * a, 2 * b).astype(np.int64)
         + _idx(p, 2 * a + 2, 2 * b + 2).astype(np.int64))
    od = _idx(p, 2 * a + 1, 2 * b + 1)
    od -= s.astype(np.int32)
    od -= ((I_LFTG_ALPHA_PRIME * s + (1 << 15)) >> 16).astype(np.int32)
    a, b = (i0 >> 1) - 1, (i1 >> 1) + 1
    ev = _idx(p, 2 * a, 2 * b)
    ev -= _q16(I_LFTG_BETA, _idx(p, 2 * a - 1, 2 * b - 1), _idx(p, 2 * a + 1, 2 * b + 1))
    a, b = (i0 >> 1) - 1, i1 >> 1
    od = _idx(p, 2 * a + 1, 2 * b + 1)
    od += _q16(I_LFTG_GAMMA, _idx(p, 2 * a, 2 * b), _idx(p, 2 * a + 2, 2 * b + 2))
    a, b = i0 >> 1, i1 >> 1
    ev = _idx(p, 2 * a, 2 * b)
    ev += _q16(I_LFTG_DELTA, _idx(p, 2 * a - 1, 2 * b - 1), _idx(p, 2 * a + 1, 2 * b + 1))


_SD = {DWT53: _sd_1d53, DWT97_INT: _sd_1d97_int}


def dwt_encode(data: np.ndarray, border, ndeclevels: int, dwt_type: int) -> np.ndarray:
    """In-place multi-level forward DWT (dwt_encode53/97_*, jpeg2000dwt.c:95-307)."""
    if ndeclevels == 0:
        return data
    linelen, mod = dwt_levels(border, ndeclevels)
    sd = _SD[dwt_type]

    if dwt_type == DWT97_INT:
        h = linelen[ndeclevels - 1][1]
        w = linelen[ndeclevels - 1][0]
        data[:h, :w] = data[:h, :w] * (1 << I_PRESHIFT)

    for lev in range(ndeclevels - 1, -1, -1):
        lh, lv = linelen[lev][0], linelen[lev][1]
        mh, mv = mod[lev][0], mod[lev][1]
        if lh <= 0 or lv <= 0:
            continue

        order = ("V", "H")

        def _enc_1d(batch: np.ndarray, ln: int, m: int) -> np.ndarray:
            """Forward 1D over a batch: contiguous in at coords [m, m+ln),
            deinterleave out (L from even coords 2m.., H from odd coords 1..)
            per dwt_encode53 copy loops (jpeg2000dwt.c:112-141)."""
            p = np.zeros((batch.shape[0], ln + 2 * _PAD + 2), dtype=batch.dtype)
            p[:, _PAD + m:_PAD + m + ln] = batch
            sd(p, m, m + ln)
            nL = len(range(m, ln, 2))
            nH = len(range(1 - m, ln, 2))
            out = np.empty_like(batch)
            out[:, :nL] = p[:, _PAD + 2 * m::2][:, :nL]
            out[:, nL:nL + nH] = p[:, _PAD + 1::2][:, :nH]
            return out

        for axis in order:
            if axis == "V":
                cols = np.ascontiguousarray(data[:lv, :lh].T)
                data[:lv, :lh] = _enc_1d(cols, lv, mv).T
            else:
                rows = np.ascontiguousarray(data[:lv, :lh])
                data[:lv, :lh] = _enc_1d(rows, lh, mh)

    if dwt_type == DWT97_INT:
        h = linelen[ndeclevels - 1][1]
        w = linelen[ndeclevels - 1][0]
        v = data[:h, :w].astype(np.int64)
        data[:h, :w] = ((v + ((1 << I_PRESHIFT) >> 1)) >> I_PRESHIFT).astype(np.int32)
    return data
