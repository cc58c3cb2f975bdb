"""Inverse/forward discrete wavelet transforms (5/3, 9/7 float, 9/7 int).

Vectorized NumPy implementation with exact behavior parity against
jpeg2000dwt.c:309-537 (decode) and :77-307 (encode): identical lifting
order, integer rounding (incl. the ALPHA' = alpha-1 split and I_PRESHIFT
scaling) and symmetric edge extension. Each lifting sweep writes one parity
and reads only the other, so whole-line batches vectorize without changing
results. The JAX/TPU version (dwt_jax.py) mirrors this structure.
"""

from __future__ import annotations

import numpy as np

I_PRESHIFT = 8

F_LFTG_ALPHA = np.float32(1.586134342059924)
F_LFTG_BETA = np.float32(0.052980118572961)
F_LFTG_GAMMA = np.float32(0.882911075530934)
F_LFTG_DELTA = np.float32(0.443506852043971)
F_LFTG_K = np.float32(1.230174104914001)
F_LFTG_X = np.float32(0.812893066115961)

# encoder-side truncated constants (jpeg2000dwt.c:161-167)
F_ENC_ALPHA = np.float32(1.586134)
F_ENC_BETA = np.float32(0.052980)
F_ENC_GAMMA = np.float32(0.882911)
F_ENC_DELTA = np.float32(0.443506)

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


def _interleave(rows: np.ndarray, lh: int, mh: int) -> np.ndarray:
    """Deinterleaved (L then H) -> interleaved line buffer, batched over rows.

    The line occupies coordinates [mh, mh+lh); L samples sit at absolutely
    even coordinates starting 2*mh, H at odd coordinates starting 1
    (dwt_decode53 copy loops, jpeg2000dwt.c:345-350).
    """
    n, _ = rows.shape
    out = np.zeros((n, lh + 2 * _PAD + 2), dtype=rows.dtype)
    nL = len(range(mh, lh, 2))
    nH = len(range(1 - mh, lh, 2))
    out[:, _PAD + 2 * mh::2][:, :nL] = rows[:, :nL]
    out[:, _PAD + 1::2][:, :nH] = rows[:, nL:nL + nH]
    return out


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


def _sr_1d53(p: np.ndarray, i0: int, i1: int) -> None:
    """Batched inverse 5/3 lifting (sr_1d53, jpeg2000dwt.c:309-325)."""
    if i1 <= i0 + 1:
        if i0 == 1:
            p[:, _PAD + 1] >>= 1
        return
    _extend(p, i0, i1, 2)
    # even: i in [i0>>1, (i1>>1)+1): p[2i] -= (p[2i-1] + p[2i+1] + 2) >> 2
    a, b = i0 >> 1, (i1 >> 1) + 1
    ev = _idx(p, 2 * a, 2 * b)
    ev -= (_idx(p, 2 * a - 1, 2 * b - 1) + _idx(p, 2 * a + 1, 2 * b + 1) + 2) >> 2
    # odd: i in [i0>>1, i1>>1): p[2i+1] += (p[2i] + p[2i+2]) >> 1
    a, b = i0 >> 1, i1 >> 1
    od = _idx(p, 2 * a + 1, 2 * b + 1)
    od += (_idx(p, 2 * a, 2 * b) + _idx(p, 2 * a + 2, 2 * b + 2)) >> 1


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


def _sr_1d97_float(p: np.ndarray, i0: int, i1: int) -> None:
    """Batched inverse 9/7 float lifting (sr_1d97_float, jpeg2000dwt.c:376-401)."""
    if i1 <= i0 + 1:
        if i0 == 1:
            p[:, _PAD + 1] *= F_LFTG_K / np.float32(2)
        else:
            p[:, _PAD + 0] *= F_LFTG_X
        return
    _extend(p, i0, i1, 4)
    a, b = (i0 >> 1) - 1, (i1 >> 1) + 2
    ev = _idx(p, 2 * a, 2 * b)
    ev -= F_LFTG_DELTA * (_idx(p, 2 * a - 1, 2 * b - 1) + _idx(p, 2 * a + 1, 2 * b + 1))
    a, b = (i0 >> 1) - 1, (i1 >> 1) + 1
    od = _idx(p, 2 * a + 1, 2 * b + 1)
    od -= F_LFTG_GAMMA * (_idx(p, 2 * a, 2 * b) + _idx(p, 2 * a + 2, 2 * b + 2))
    a, b = i0 >> 1, (i1 >> 1) + 1
    ev = _idx(p, 2 * a, 2 * b)
    ev += F_LFTG_BETA * (_idx(p, 2 * a - 1, 2 * b - 1) + _idx(p, 2 * a + 1, 2 * b + 1))
    a, b = i0 >> 1, i1 >> 1
    od = _idx(p, 2 * a + 1, 2 * b + 1)
    od += F_LFTG_ALPHA * (_idx(p, 2 * a, 2 * b) + _idx(p, 2 * a + 2, 2 * b + 2))


def _sd_1d97_float(p: np.ndarray, i0: int, i1: int) -> None:
    """Batched forward 9/7 float lifting (sd_1d97_float, jpeg2000dwt.c:145-168)."""
    if i1 <= i0 + 1:
        if i0 == 1:
            p[:, _PAD + 1] *= F_LFTG_X * np.float32(2)
        else:
            p[:, _PAD + 0] *= F_LFTG_K
        return
    _extend(p, i0, i1, 4)
    i0 += 1
    i1 += 1
    a, b = (i0 >> 1) - 2, (i1 >> 1) + 1
    od = _idx(p, 2 * a + 1, 2 * b + 1)
    od -= F_ENC_ALPHA * (_idx(p, 2 * a, 2 * b) + _idx(p, 2 * a + 2, 2 * b + 2))
    a, b = (i0 >> 1) - 1, (i1 >> 1) + 1
    ev = _idx(p, 2 * a, 2 * b)
    ev -= F_ENC_BETA * (_idx(p, 2 * a - 1, 2 * b - 1) + _idx(p, 2 * a + 1, 2 * b + 1))
    a, b = (i0 >> 1) - 1, i1 >> 1
    od = _idx(p, 2 * a + 1, 2 * b + 1)
    od += F_ENC_GAMMA * (_idx(p, 2 * a, 2 * b) + _idx(p, 2 * a + 2, 2 * b + 2))
    a, b = i0 >> 1, i1 >> 1
    ev = _idx(p, 2 * a, 2 * b)
    ev += F_ENC_DELTA * (_idx(p, 2 * a - 1, 2 * b - 1) + _idx(p, 2 * a + 1, 2 * b + 1))


def _q16(coef: int, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """(coef * (x + y) + 2^15) >> 16 in int64, truncated to int32."""
    s = x.astype(np.int64) + y.astype(np.int64)
    return ((coef * s + (1 << 15)) >> 16).astype(np.int32)


def _sr_1d97_int(p: np.ndarray, i0: int, i1: int) -> None:
    """Batched inverse 9/7 int lifting (sr_1d97_int, jpeg2000dwt.c:453-481)."""
    if i1 <= i0 + 1:
        if i0 == 1:
            p[:, _PAD + 1] = ((p[:, _PAD + 1].astype(np.int64) * I_LFTG_K
                               + (1 << 16)) >> 17).astype(np.int32)
        else:
            p[:, _PAD + 0] = ((p[:, _PAD + 0].astype(np.int64) * I_LFTG_X
                               + (1 << 15)) >> 16).astype(np.int32)
        return
    _extend(p, i0, i1, 4)
    a, b = (i0 >> 1) - 1, (i1 >> 1) + 2
    ev = _idx(p, 2 * a, 2 * b)
    ev -= _q16(I_LFTG_DELTA, _idx(p, 2 * a - 1, 2 * b - 1), _idx(p, 2 * a + 1, 2 * b + 1))
    a, b = (i0 >> 1) - 1, (i1 >> 1) + 1
    od = _idx(p, 2 * a + 1, 2 * b + 1)
    od -= _q16(I_LFTG_GAMMA, _idx(p, 2 * a, 2 * b), _idx(p, 2 * a + 2, 2 * b + 2))
    a, b = i0 >> 1, (i1 >> 1) + 1
    ev = _idx(p, 2 * a, 2 * b)
    ev += _q16(I_LFTG_BETA, _idx(p, 2 * a - 1, 2 * b - 1), _idx(p, 2 * a + 1, 2 * b + 1))
    # step 6: p[2i+1] += sum; p[2i+1] += (ALPHA' * sum + 2^15) >> 16
    a, b = i0 >> 1, i1 >> 1
    s = (_idx(p, 2 * a, 2 * b).astype(np.int64)
         + _idx(p, 2 * a + 2, 2 * b + 2).astype(np.int64))
    od = _idx(p, 2 * a + 1, 2 * b + 1)
    od += s.astype(np.int32)
    od += ((I_LFTG_ALPHA_PRIME * s + (1 << 15)) >> 16).astype(np.int32)


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


_SR = {DWT53: _sr_1d53, DWT97: _sr_1d97_float, DWT97_INT: _sr_1d97_int}
_SD = {DWT53: _sd_1d53, DWT97: _sd_1d97_float, DWT97_INT: _sd_1d97_int}


def dwt_decode(data: np.ndarray, border, ndeclevels: int, dwt_type: int) -> np.ndarray:
    """In-place multi-level inverse DWT over a (H, W) plane.

    `data` must be the full-size component plane; subband coefficients are
    laid out per the JPEG 2000 deinterleaved convention. Parity:
    dwt_decode53/97_int/97_float (jpeg2000dwt.c:327-537).
    """
    if ndeclevels == 0:
        return data
    linelen, mod = dwt_levels(border, ndeclevels)
    sr = _SR[dwt_type]

    if dwt_type == DWT97_INT:
        pass  # input already preshifted by dequantization_int_97

    for lev in range(ndeclevels):
        lh, lv = linelen[lev][0], linelen[lev][1]
        mh, mv = mod[lev][0], mod[lev][1]

        # HOR: batch all lv rows
        if lh > 0 and lv > 0:
            rows = data[:lv, :lh]
            p = _interleave(rows, lh, mh)
            sr(p, mh, mh + lh)
            data[:lv, :lh] = p[:, _PAD + mh:_PAD + mh + lh]

            # VER: batch all lh columns (transpose)
            cols = np.ascontiguousarray(data[:lv, :lh].T)
            p = _interleave(cols, lv, mv)
            sr(p, mv, mv + lv)
            data[:lv, :lh] = p[:, _PAD + mv:_PAD + mv + lv].T

    if dwt_type == DWT97_INT:
        # final downshift (jpeg2000dwt.c:534-536)
        h = linelen[ndeclevels - 1][1]
        w = linelen[ndeclevels - 1][0]
        v = data[:h, :w].astype(np.int64)
        data[:h, :w] = ((v + ((1 << I_PRESHIFT) >> 1)) >> I_PRESHIFT).astype(np.int32)
    return data


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

        if dwt_type == DWT97:
            # encode97_float does HOR first (jpeg2000dwt.c:185-218)
            order = ("H", "V")
        else:
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
