"""The tile plan of ``csrc/dwt_lift.cu``, emulated in torch on the CPU.

The kernel lifts a level tile by tile: each tile's window reaches
``HALO_PAIRS`` (E, O) pairs past it on every side, starts at an even
absolute row and column, loads the positions within the halo of the
level from their mirrors inside it and leaves the others unloaded, runs
every horizontal step on all the window's rows (a window edge's missing
neighbour is junk), then every vertical step, and keeps only the tile's
own samples. Here the same windows are built from the same constants
(``ops/dwt_cuda``: ``TILE_ROWS``, ``tile_cols``, ``HALO_PAIRS``,
``WINDOW_PAIRS``), with a poison value (NaN for float) wherever the
kernel would hold junk, and the emulated level must equal
``dwt_level_ref`` bit for bit: every transform, every origin-parity pair,
8x8, sizes around a tile, and levels narrower than one window. A halo one
pair short must not. ``dwt_level_ref`` itself is held to the JAX package
by ``tests/test_torch_coef_dwt.py``.
"""

import numpy as np
import pytest
import torch

from ffmpeg_ht_tpu_torch.ops import dwt_cuda, dwt_torch
from ffmpeg_ht_tpu_torch.ops.dwt import (DWT53, DWT97, DWT97_INT,
                                         I_LFTG_ALPHA_PRIME, I_LFTG_BETA,
                                         I_LFTG_DELTA, I_LFTG_GAMMA)

T = {"53": DWT53, "int": DWT97_INT, "float": DWT97}
_POISON_INT = 0x2B5A5A5B


def _step(transform, st, x, a, b):
    """Lifting step `st` of `transform` on x with neighbours a, b (the
    arithmetic of dwt_torch's _poly_sr53 / _poly_sr97i / _poly_sr97f)."""
    if transform == DWT53:
        return x - ((a + b + 2) >> 2) if st == 0 else x + ((a + b) >> 1)
    if transform == DWT97:
        c = (dwt_torch._F_DELTA, dwt_torch._F_GAMMA, dwt_torch._F_BETA,
             dwt_torch._F_ALPHA)[st]
        return x - c * (a + b) if st < 2 else x + c * (a + b)
    if st < 3:
        d = dwt_torch._q16j((I_LFTG_DELTA, I_LFTG_GAMMA, I_LFTG_BETA)[st],
                            a, b)
        return x - d if st < 2 else x + d
    s = a.to(torch.int64) + b.to(torch.int64)
    return x + (s.to(torch.int32)
                + ((I_LFTG_ALPHA_PRIME * s + (1 << 15)) >> 16)
                .to(torch.int32))


def _lift(win, transform, axis, poison):
    """Every lifting step along `axis` of the window, in place; a sample
    at the window's edge has a missing neighbour and becomes poison."""
    v = win if axis == 0 else win.t()
    n = v.shape[0]
    for st in range(2 if transform == DWT53 else 4):
        q = st & 1
        lo = 2 - q                         # 2 for E (even), 1 for O (odd)
        v[lo:n - 1:2] = _step(transform, st, v[lo:n - 1:2],
                              v[lo - 1:n - 2:2], v[lo + 1:n:2])
        v[q if q == 0 else n - 1] = poison


def _mirror(i, lo, hi):
    return torch.where(i < lo, 2 * lo - i,
                       torch.where(i >= hi, 2 * (hi - 1) - i, i))


def emulate_level(ll, hl, lh, hh, mh, mv, transform, preshift,
                  halo_pairs=None):
    """One level through the kernel's tiles (see the module docstring)."""
    hp = dwt_cuda.HALO_PAIRS[transform] if halo_pairs is None \
        else halo_pairs
    halo, rows = 2 * hp, dwt_cuda.TILE_ROWS
    cols = 2 * dwt_cuda.WINDOW_PAIRS - 2 * halo
    nrows, ncols = rows + 2 * halo, 2 * dwt_cuda.WINDOW_PAIRS
    w, h = ll.shape[1] + hl.shape[1], ll.shape[0] + lh.shape[0]
    poison = float("nan") if ll.dtype == torch.float32 else _POISON_INT
    out = torch.full((h, w), poison, dtype=ll.dtype)
    written = torch.zeros((h, w), dtype=torch.int32)
    for ty in range(-(-(mv + h) // rows)):
        for tx in range(-(-(mh + w) // cols)):
            a0, b0 = ty * rows - halo, tx * cols - halo
            y = a0 + torch.arange(nrows)
            x = b0 + torch.arange(ncols)
            ym, xm = _mirror(y, mv, mv + h), _mirror(x, mh, mh + w)
            # band row / column of each window row / column (E even, O odd)
            ry = torch.where(y % 2 == 0, (ym >> 1) - ((mv + 1) >> 1),
                             ((ym - 1) >> 1) - (mv >> 1))
            cx = torch.where(x % 2 == 0, (xm >> 1) - ((mh + 1) >> 1),
                             ((xm - 1) >> 1) - (mh >> 1))
            win = torch.full((nrows, ncols), poison, dtype=ll.dtype)
            for py, px, band in ((0, 0, ll), (0, 1, hl), (1, 0, lh),
                                 (1, 1, hh)):
                ri = ((y % 2 == py) & (y >= mv - halo)
                      & (y < mv + h + halo)).nonzero().flatten()
                ci = ((x % 2 == px) & (x >= mh - halo)
                      & (x < mh + w + halo)).nonzero().flatten()
                win[ri[:, None], ci[None, :]] = \
                    band[ry[ri][:, None], cx[ci][None, :]]
            _lift(win, transform, 1, poison)           # rows, every row
            _lift(win, transform, 0, poison)           # then columns
            keep_r = torch.arange(halo, halo + rows)
            keep_c = torch.arange(halo, halo + cols)
            keep_r = keep_r[(a0 + keep_r >= mv) & (a0 + keep_r < mv + h)]
            keep_c = keep_c[(b0 + keep_c >= mh) & (b0 + keep_c < mh + w)]
            orow = (a0 + keep_r - mv)[:, None]
            ocol = (b0 + keep_c - mh)[None, :]
            out[orow, ocol] = win[keep_r[:, None], keep_c[None, :]]
            written[orow, ocol] += 1
    assert bool((written == 1).all()), "a sample written other than once"
    return dwt_torch._preshift(out) if preshift else out


def _bands(rng, w, h, mh, mv, transform):
    nE, nEv = (w + 1 - mh) // 2, (h + 1 - mv) // 2
    dt = np.float32 if transform == DWT97 else np.int32
    r = lambda s: torch.from_numpy(rng.integers(-4000, 4000, s).astype(dt))
    return r((nEv, nE)), r((nEv, w - nE)), r((h - nEv, nE)), \
        r((h - nEv, w - nE))


def _same_bits(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def _sizes(transform):
    """(h, w): the 8x8 minimum, one under / one over a tile and two tiles
    on both axes, levels narrower or shorter than one window."""
    rows, cols = dwt_cuda.TILE_ROWS, dwt_cuda.tile_cols(transform)
    return [(8, 8), (rows - 1, cols - 1), (rows + 1, cols + 1),
            (2 * rows, 2 * cols), (37, 100), (9, 300), (150, 13)]


@pytest.mark.parametrize("size", range(7))
@pytest.mark.parametrize("mh,mv", [(0, 0), (1, 0), (0, 1), (1, 1)])
@pytest.mark.parametrize("tname", list(T))
def test_tiles_equal_the_plain_level(tname, mh, mv, size):
    t = T[tname]
    h, w = _sizes(t)[size]
    rng = np.random.default_rng(size * 8 + mh * 2 + mv)
    bands = _bands(rng, w, h, mh, mv, t)
    pre = t == DWT97_INT
    got = emulate_level(*bands, mh, mv, t, pre)
    assert _same_bits(got, dwt_torch.dwt_level_ref(*bands, mh, mv, t, pre))


@pytest.mark.parametrize("tname", list(T))
def test_a_halo_one_pair_short_differs(tname):
    """The halo is the least that works: one pair less spoils samples at
    the tiles' seams (while the full halo gives the plain level)."""
    t = T[tname]
    h, w = 2 * dwt_cuda.TILE_ROWS + 6, 2 * dwt_cuda.tile_cols(t) + 6
    bands = _bands(np.random.default_rng(7), w, h, 0, 0, t)
    want = dwt_torch.dwt_level_ref(*bands, 0, 0, t)
    assert _same_bits(emulate_level(*bands, 0, 0, t, False), want)
    short = emulate_level(*bands, 0, 0, t, False,
                          halo_pairs=dwt_cuda.HALO_PAIRS[t] - 1)
    assert not _same_bits(short, want)
