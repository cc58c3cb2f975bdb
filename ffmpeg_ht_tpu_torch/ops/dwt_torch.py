"""Inverse DWT (5/3, 9/7 integer, 9/7 float) in PyTorch.

Port of ``ffmpeg_ht_tpu.ops.dwt_jax``, bit-exact against ``ops/dwt.py``
(jpeg2000dwt.c:309-537) for 5/3 and the integer 9/7: same op order, same
integer rounding, int64 exactly where the reference widens. The float
9/7 composes float32 constants with a float32 result after every op, as
the reference does.

Two formulations, as in the JAX package:

- the polyphase path (``dwt_decode_bands``, counterpart of
  ``dwt_jax.dwt_decode_bands``): each lifting sweep runs on the separate
  even/odd (L/H) polyphase arrays with contiguous slices, the symmetric
  extension mirrored into the valid range (lifting commutes with it), and
  the final interleave is a stack and a reshape. It is fed the subband
  arrays directly, so the quadrant pyramid is never assembled. It needs
  every level to be at least 8x8 (``dwt_poly_capable``);
- the flat fallback (``dwt_decode_flat``, counterpart of
  ``dwt_jax._dwt_decode_traced``) on the assembled quadrant pyramid: the
  polyphase sweep for levels of at least 8x8, and the interleaved line
  buffer of the reference (``_interleave``, ``_extend``, ``_sr53`` /
  ``_sr97i`` / ``_sr97f``) for the smaller ones. JAX updates its buffers
  functionally; here the line buffers are updated in place, each right-hand
  side computed before it is assigned, in the same order.

The JAX package runs this stage as XLA ops, not Pallas, so these are
plain torch ops on either device.
"""

from __future__ import annotations

import torch

from ffmpeg_ht_tpu_torch.ops.dwt import (DWT53, DWT97, DWT97_INT,
                                         F_LFTG_ALPHA, F_LFTG_BETA,
                                         F_LFTG_DELTA, F_LFTG_GAMMA,
                                         F_LFTG_K, F_LFTG_X,
                                         I_LFTG_ALPHA_PRIME, I_LFTG_BETA,
                                         I_LFTG_DELTA, I_LFTG_GAMMA,
                                         I_LFTG_K, I_LFTG_X, I_PRESHIFT,
                                         dwt_levels)

_PAD = 8
# float32 lifting constants (dwt_jax.py:25-30) as Python floats holding
# the float32 values exactly; torch rounds a float32 tensor times such a
# scalar to float32
_F_DELTA = float(F_LFTG_DELTA)
_F_GAMMA = float(F_LFTG_GAMMA)
_F_BETA = float(F_LFTG_BETA)
_F_ALPHA = float(F_LFTG_ALPHA)
_F_K_HALF = float(F_LFTG_K) / 2      # exact: K / 2 in float32
_F_X = float(F_LFTG_X)


def _q16j(coef: int, x, y):
    """(coef * (x + y) + 2^15) >> 16 in int64, truncated to int32."""
    s = x.to(torch.int64) + y.to(torch.int64)
    return ((coef * s + (1 << 15)) >> 16).to(torch.int32)


def _preshift(v):
    """The integer 9/7's final rounding shift (jpeg2000dwt.c:534-536)."""
    v = v.to(torch.int64)
    return ((v + ((1 << I_PRESHIFT) >> 1)) >> I_PRESHIFT).to(torch.int32)


# ---------------------------------------------------------------------------
# the interleaved line buffer (flat fallback, levels below 8x8)
# ---------------------------------------------------------------------------


def _interleave(rows, lh: int, mh: int):
    """L/H halves -> interleaved padded lines (see ops/dwt._interleave)."""
    n = rows.shape[0]
    nL = len(range(mh, lh, 2))
    nH = len(range(1 - mh, lh, 2))
    out = rows.new_zeros((n, lh + 2 * _PAD + 2))
    out[:, _PAD + 2 * mh:_PAD + 2 * mh + 2 * nL:2] = rows[:, :nL]
    out[:, _PAD + 1:_PAD + 1 + 2 * nH:2] = rows[:, nL:nL + nH]
    return out


def _extend(p, i0: int, i1: int, reach: int) -> None:
    """Symmetric extension in place: reach 2 for 5/3, 4 for 9/7."""
    b = _PAD
    if reach == 2:
        p[:, b + i0 - 1] = p[:, b + i0 + 1]
        p[:, b + i1] = p[:, b + i1 - 2]
        p[:, b + i0 - 2] = p[:, b + i0 + 2]
        p[:, b + i1 + 1] = p[:, b + i1 - 3]
    else:
        for i in range(1, 5):
            p[:, b + i0 - i] = p[:, b + i0 + i]
            p[:, b + i1 + i - 1] = p[:, b + i1 - i - 1]


def _sl(p, lo: int, hi: int):
    """Positions lo, lo+2, ... < hi of every line (a strided view)."""
    return p[:, _PAD + lo:_PAD + hi:2]


def _upd(p, lo: int, hi: int, delta, op) -> None:
    p[:, _PAD + lo:_PAD + hi:2] = op(_sl(p, lo, hi), delta)


def _sr53(p, i0: int, i1: int) -> None:
    """Inverse 5/3 lifting (sr_1d53) on the interleaved lines, in place."""
    if i1 <= i0 + 1:
        if i0 == 1:
            p[:, _PAD + 1] = p[:, _PAD + 1] >> 1
        return
    _extend(p, i0, i1, 2)
    a, b = i0 >> 1, (i1 >> 1) + 1
    d = (_sl(p, 2 * a - 1, 2 * b - 1) + _sl(p, 2 * a + 1, 2 * b + 1) + 2) >> 2
    _upd(p, 2 * a, 2 * b, d, torch.sub)
    a, b = i0 >> 1, i1 >> 1
    d = (_sl(p, 2 * a, 2 * b) + _sl(p, 2 * a + 2, 2 * b + 2)) >> 1
    _upd(p, 2 * a + 1, 2 * b + 1, d, torch.add)


def _sr97i(p, i0: int, i1: int) -> None:
    """Inverse integer 9/7 lifting (sr_1d97_int), in place."""
    if i1 <= i0 + 1:
        if i0 == 1:
            v = (p[:, _PAD + 1].to(torch.int64) * I_LFTG_K + (1 << 16)) >> 17
            p[:, _PAD + 1] = v.to(torch.int32)
        else:
            v = (p[:, _PAD + 0].to(torch.int64) * I_LFTG_X + (1 << 15)) >> 16
            p[:, _PAD + 0] = v.to(torch.int32)
        return
    _extend(p, i0, i1, 4)
    a, b = (i0 >> 1) - 1, (i1 >> 1) + 2
    d = _q16j(I_LFTG_DELTA, _sl(p, 2 * a - 1, 2 * b - 1),
              _sl(p, 2 * a + 1, 2 * b + 1))
    _upd(p, 2 * a, 2 * b, d, torch.sub)
    a, b = (i0 >> 1) - 1, (i1 >> 1) + 1
    d = _q16j(I_LFTG_GAMMA, _sl(p, 2 * a, 2 * b), _sl(p, 2 * a + 2, 2 * b + 2))
    _upd(p, 2 * a + 1, 2 * b + 1, d, torch.sub)
    a, b = i0 >> 1, (i1 >> 1) + 1
    d = _q16j(I_LFTG_BETA, _sl(p, 2 * a - 1, 2 * b - 1),
              _sl(p, 2 * a + 1, 2 * b + 1))
    _upd(p, 2 * a, 2 * b, d, torch.add)
    a, b = i0 >> 1, i1 >> 1
    s = (_sl(p, 2 * a, 2 * b).to(torch.int64)
         + _sl(p, 2 * a + 2, 2 * b + 2).to(torch.int64))
    d = s.to(torch.int32) \
        + ((I_LFTG_ALPHA_PRIME * s + (1 << 15)) >> 16).to(torch.int32)
    _upd(p, 2 * a + 1, 2 * b + 1, d, torch.add)


def _sr97f(p, i0: int, i1: int) -> None:
    """Inverse float 9/7 lifting (sr_1d97_float), in place."""
    if i1 <= i0 + 1:
        if i0 == 1:
            p[:, _PAD + 1] = p[:, _PAD + 1] * _F_K_HALF
        else:
            p[:, _PAD + 0] = p[:, _PAD + 0] * _F_X
        return
    _extend(p, i0, i1, 4)
    a, b = (i0 >> 1) - 1, (i1 >> 1) + 2
    d = _F_DELTA * (_sl(p, 2 * a - 1, 2 * b - 1) + _sl(p, 2 * a + 1, 2 * b + 1))
    _upd(p, 2 * a, 2 * b, d, torch.sub)
    a, b = (i0 >> 1) - 1, (i1 >> 1) + 1
    d = _F_GAMMA * (_sl(p, 2 * a, 2 * b) + _sl(p, 2 * a + 2, 2 * b + 2))
    _upd(p, 2 * a + 1, 2 * b + 1, d, torch.sub)
    a, b = i0 >> 1, (i1 >> 1) + 1
    d = _F_BETA * (_sl(p, 2 * a - 1, 2 * b - 1) + _sl(p, 2 * a + 1, 2 * b + 1))
    _upd(p, 2 * a, 2 * b, d, torch.add)
    a, b = i0 >> 1, i1 >> 1
    d = _F_ALPHA * (_sl(p, 2 * a, 2 * b) + _sl(p, 2 * a + 2, 2 * b + 2))
    _upd(p, 2 * a + 1, 2 * b + 1, d, torch.add)


_SR = {DWT53: _sr53, DWT97: _sr97f, DWT97_INT: _sr97i}


# ---------------------------------------------------------------------------
# polyphase lifting
# ---------------------------------------------------------------------------


def _mcat(A, lo: int, hi: int, vlo: int, vhi: int, mlo, mhi, axis: int):
    """Values V[i], i in [lo, hi), where V[i] = A[i - vlo] along `axis`
    for valid i in [vlo, vhi) and out-of-range i reflect through the
    static index maps mlo / mhi."""
    parts = []
    for i in range(lo, min(hi, vlo)):
        parts.append(A.narrow(axis, mlo(i) - vlo, 1))
    mid_lo, mid_hi = max(lo, vlo), min(hi, vhi)
    if mid_hi > mid_lo:
        parts.append(A.narrow(axis, mid_lo - vlo, mid_hi - mid_lo))
    for i in range(max(lo, vhi), hi):
        parts.append(A.narrow(axis, mhi(i) - vlo, 1))
    return parts[0] if len(parts) == 1 else torch.cat(parts, axis)


def _mpad_pair(A, lo: int, hi: int, vlo: int, vhi: int, mlo, mhi,
               axis: int):
    """(V[i], V[i+1]) for i in [lo, hi), as two overlapping slices of one
    mirror-padded array spanning [lo, hi + 1)."""
    pad = _mcat(A, lo, hi + 1, vlo, vhi, mlo, mhi, axis)
    n = hi - lo
    return pad.narrow(axis, 0, n), pad.narrow(axis, 1, n)


def _poly_ranges(i0: int, i1: int):
    """Valid polyphase index ranges and mirror maps for a line [i0, i1).
    E[i] = p[2i], O[i] = p[2i+1]."""
    e_lo, e_hi = (i0 + 1) // 2, (i1 - 1) // 2 + 1
    o_lo, o_hi = i0 // 2, (i1 - 2) // 2 + 1
    return ((e_lo, e_hi, lambda i: i0 - i, lambda i: i1 - 1 - i),
            (o_lo, o_hi, lambda i: i0 - i - 1, lambda i: i1 - i - 2))


def _poly_pairs(i0: int, i1: int, axis: int):
    """(pair_o, pair_e): the mirrored neighbour pairs that the even
    sweeps read from O and the odd sweeps read from E."""
    (e_lo, e_hi, e_mlo, e_mhi), (o_lo, o_hi, o_mlo, o_mhi) = \
        _poly_ranges(i0, i1)

    def pair_o(O):
        return _mpad_pair(O, e_lo - 1, e_hi - 1, o_lo, o_hi, o_mlo, o_mhi,
                          axis)

    def pair_e(E):
        return _mpad_pair(E, o_lo, o_hi, e_lo, e_hi, e_mlo, e_mhi, axis)
    return pair_o, pair_e


def _poly_sr53(E, O, i0: int, i1: int, axis: int):
    """Inverse 5/3 lifting (sr_1d53) on the polyphase pair."""
    pair_o, pair_e = _poly_pairs(i0, i1, axis)
    OL, OR = pair_o(O)
    E = E - ((OL + OR + 2) >> 2)
    EL, ER = pair_e(E)
    O = O + ((EL + ER) >> 1)
    return E, O


def _poly_sr97i(E, O, i0: int, i1: int, axis: int):
    """Inverse integer 9/7 lifting (sr_1d97_int) on the polyphase pair."""
    pair_o, pair_e = _poly_pairs(i0, i1, axis)
    E = E - _q16j(I_LFTG_DELTA, *pair_o(O))
    O = O - _q16j(I_LFTG_GAMMA, *pair_e(E))
    E = E + _q16j(I_LFTG_BETA, *pair_o(O))
    a, b = pair_e(E)
    s = a.to(torch.int64) + b.to(torch.int64)
    d = s.to(torch.int32) \
        + ((I_LFTG_ALPHA_PRIME * s + (1 << 15)) >> 16).to(torch.int32)
    return E, O + d


def _poly_sr97f(E, O, i0: int, i1: int, axis: int):
    """Inverse float 9/7 lifting (sr_1d97_float) on the polyphase pair."""
    pair_o, pair_e = _poly_pairs(i0, i1, axis)
    a, b = pair_o(O)
    E = E - _F_DELTA * (a + b)
    a, b = pair_e(E)
    O = O - _F_GAMMA * (a + b)
    a, b = pair_o(O)
    E = E + _F_BETA * (a + b)
    a, b = pair_e(E)
    O = O + _F_ALPHA * (a + b)
    return E, O


_POLY_SR = {DWT53: _poly_sr53, DWT97: _poly_sr97f, DWT97_INT: _poly_sr97i}


def _poly_interleave(E, O, i0: int, i1: int, axis: int):
    """Interleave the polyphase arrays back into line order [i0, i1)."""
    first, second = (E, O) if (i0 & 1) == 0 else (O, E)
    nf, ns = first.shape[axis], second.shape[axis]
    if ns < nf:
        second = torch.cat([second, second.narrow(axis, 0, nf - ns)], axis)
    x = torch.stack([first, second], axis + 1)
    shape = list(first.shape)
    shape[axis] = 2 * nf
    x = x.reshape(shape)
    if shape[axis] != i1 - i0:
        x = x.narrow(axis, 0, i1 - i0)
    return x


def _poly_level(rows, lh: int, lv: int, mh: int, mv: int, sr_poly):
    """One level, both dims, polyphase: `rows` is the (lv, lh) level view
    with its L|H halves along each axis."""
    nLh = len(range(mh, lh, 2))
    E, O = sr_poly(rows[:, :nLh], rows[:, nLh:lh], mh, mh + lh, axis=1)
    x = _poly_interleave(E, O, mh, mh + lh, axis=1)
    nLv = len(range(mv, lv, 2))
    E, O = sr_poly(x[:nLv], x[nLv:lv], mv, mv + lv, axis=0)
    return _poly_interleave(E, O, mv, mv + lv, axis=0)


def dwt_poly_capable(border, ndeclevels: int) -> bool:
    """True when every level of this geometry has both dims >= 8, the
    precondition of the polyphase path."""
    if ndeclevels == 0:
        return False
    linelen, _mod = dwt_levels(border, ndeclevels)
    return all(linelen[lev][0] >= 8 and linelen[lev][1] >= 8
               for lev in range(ndeclevels))


def dwt_level_ref(ll, hl, lhb, hh, mh: int, mv: int, dwt_type: int,
                  preshift: bool = False):
    """One band-direct level: the next LL (lv, lh) from the previous LL
    (nLv, nLh) and the level's HL (nLv, nHh), LH (nHv, nLh) and HH (nHv,
    nHh), with origin parities mh, mv (``dwt_levels``' mod). Rows first
    (LL | HL, then LH | HH), then columns; with `preshift` the integer
    9/7's final rounding shift after it. The plain version of the kernel
    ``csrc/dwt_lift.cu`` (ops/dwt_cuda.dwt_lift)."""
    sr_poly = _POLY_SR[dwt_type]
    lh, lv = ll.shape[1] + hl.shape[1], ll.shape[0] + lhb.shape[0]
    E, O = sr_poly(ll, hl, mh, mh + lh, axis=1)
    top = _poly_interleave(E, O, mh, mh + lh, axis=1)
    E, O = sr_poly(lhb, hh, mh, mh + lh, axis=1)
    bot = _poly_interleave(E, O, mh, mh + lh, axis=1)
    E, O = sr_poly(top, bot, mv, mv + lv, axis=0)
    p = _poly_interleave(E, O, mv, mv + lv, axis=0)
    return _preshift(p) if preshift else p


def dwt_level_small_ref(ll, hl, lhb, hh, mh: int, mv: int, dwt_type: int,
                        preshift: bool = False):
    """One level whose width or height is under 8, from its four bands
    (shapes as in ``dwt_level_ref``; a band may be empty): what
    ``dwt_decode_flat`` computes for such a level, the rows ``[LL | HL]``
    over ``[LH | HH]`` through the interleaved line buffer (``_interleave``
    and ``_SR``) on rows, then on columns, a line of one sample included;
    with `preshift` the integer 9/7's final rounding shift after it. The
    plain version of the kernel ``csrc/dwt_small.cu``
    (ops/dwt_cuda.dwt_small)."""
    sr = _SR[dwt_type]
    lh, lv = lhb.shape[1] + hl.shape[1], hl.shape[0] + lhb.shape[0]
    rows = torch.cat([torch.cat([ll, hl], 1), torch.cat([lhb, hh], 1)], 0)
    p = _interleave(rows, lh, mh)
    sr(p, mh, mh + lh)
    cols = p[:, _PAD + mh:_PAD + mh + lh].t()
    p = _interleave(cols, lv, mv)
    sr(p, mv, mv + lv)
    p = p[:, _PAD + mv:_PAD + mv + lv].t().contiguous()
    return _preshift(p) if preshift else p


def dwt_decode_bands(ll, levels, border, ndeclevels: int, dwt_type: int):
    """Multi-level inverse DWT from subband arrays (polyphase path only).

    ll: the level-0 lowband (int32, float32 for DWT97); levels:
    [(hl, lh, hh), ...] from low to high resolution. Raises ValueError
    unless dwt_poly_capable(border, ndeclevels)."""
    if not dwt_poly_capable(border, ndeclevels):
        raise ValueError(f"border {border} with {ndeclevels} levels has a "
                         "level below 8x8: use dwt_decode_flat")
    _linelen, mod = dwt_levels(border, ndeclevels)
    p = ll
    for lev in range(ndeclevels):
        p = dwt_level_ref(p, *levels[lev], *mod[lev], dwt_type,
                          dwt_type == DWT97_INT and lev == ndeclevels - 1)
    return p


def dwt_decode_flat(data, border, ndeclevels: int, dwt_type: int):
    """Multi-level inverse DWT of an assembled (H, W) quadrant pyramid
    (counterpart of ``dwt_jax._dwt_decode_traced``): the polyphase sweep
    for levels of at least 8x8, the interleaved line buffer below. Returns
    a new tensor; `data` is not modified."""
    if ndeclevels == 0:
        return data
    linelen, mod = dwt_levels(border, ndeclevels)
    sr, sr_poly = _SR[dwt_type], _POLY_SR[dwt_type]
    data = data.clone()
    for lev in range(ndeclevels):
        lh, lv = linelen[lev]
        mh, mv = mod[lev]
        if lh <= 0 or lv <= 0:
            continue
        rows = data[:lv, :lh]
        if lh >= 8 and lv >= 8:
            data[:lv, :lh] = _poly_level(rows, lh, lv, mh, mv, sr_poly)
            continue
        p = _interleave(rows, lh, mh)
        sr(p, mh, mh + lh)
        cols = p[:, _PAD + mh:_PAD + mh + lh].t()
        p = _interleave(cols, lv, mv)
        sr(p, mv, mv + lv)
        data[:lv, :lh] = p[:, _PAD + mv:_PAD + mv + lv].t()
    if dwt_type == DWT97_INT:
        h, w = linelen[ndeclevels - 1][1], linelen[ndeclevels - 1][0]
        data[:h, :w] = _preshift(data[:h, :w])
    return data
