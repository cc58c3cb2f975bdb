"""Band-direct inverse 5/3 DWT (polyphase lifting) in PyTorch.

Port of the polyphase path of ``ffmpeg_ht_tpu.ops.dwt_jax``: each lifting
sweep runs on the separate even/odd (L/H) polyphase arrays with
contiguous slices, the symmetric extension mirrored into the valid range
(lifting commutes with it), and the final interleave is a stack and a
reshape. ``dwt_decode_bands`` is fed the subband arrays directly, so the
quadrant pyramid is never assembled. Bit-exact against ``ops/dwt.py``
(jpeg2000dwt.c:309-325): same op order, same integer rounding.

The JAX package runs this stage as XLA ops, not Pallas, so these are
plain torch ops on either device. Only the reversible 5/3 transform is
ported; 9/7 raises NotImplementedError (ROADMAP.md module 4).
"""

from __future__ import annotations

import torch

from ffmpeg_ht_tpu_torch.ops.dwt import DWT53, dwt_levels


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


def _poly_sr53(E, O, i0: int, i1: int, axis: int):
    """Inverse 5/3 lifting (sr_1d53) on the polyphase pair."""
    (e_lo, e_hi, e_mlo, e_mhi), (o_lo, o_hi, o_mlo, o_mhi) = \
        _poly_ranges(i0, i1)
    OL, OR = _mpad_pair(O, e_lo - 1, e_hi - 1, o_lo, o_hi, o_mlo, o_mhi,
                        axis)
    E = E - ((OL + OR + 2) >> 2)
    EL, ER = _mpad_pair(E, o_lo, o_hi, e_lo, e_hi, e_mlo, e_mhi, axis)
    O = O + ((EL + ER) >> 1)
    return E, O


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


def dwt_poly_capable(border, ndeclevels: int) -> bool:
    """True when every level of this geometry has both dims >= 8, the
    precondition of the polyphase path."""
    if ndeclevels == 0:
        return False
    linelen, _mod = dwt_levels(border, ndeclevels)
    return all(linelen[lev][0] >= 8 and linelen[lev][1] >= 8
               for lev in range(ndeclevels))


def dwt_decode_bands(ll, levels, border, ndeclevels: int, dwt_type: int):
    """Multi-level inverse DWT from subband arrays (polyphase path only).

    ll: the level-0 lowband (int32); levels: [(hl, lh, hh), ...] from low
    to high resolution. Requires dwt_poly_capable(border, ndeclevels)."""
    if dwt_type != DWT53:
        raise NotImplementedError(
            "inverse 9/7 is not ported yet (ROADMAP.md module 4: the "
            "9/7-int and 9/7-float tail); only the reversible 5/3 is")
    linelen, mod = dwt_levels(border, ndeclevels)
    p = ll
    for lev in range(ndeclevels):
        lh, lv = linelen[lev]
        mh, mv = mod[lev]
        hl, lhb, hh = levels[lev]
        E, O = _poly_sr53(p, hl, mh, mh + lh, axis=1)
        top = _poly_interleave(E, O, mh, mh + lh, axis=1)
        E, O = _poly_sr53(lhb, hh, mh, mh + lh, axis=1)
        bot = _poly_interleave(E, O, mh, mh + lh, axis=1)
        E, O = _poly_sr53(top, bot, mv, mv + lv, axis=0)
        p = _poly_interleave(E, O, mv, mv + lv, axis=0)
    return p
