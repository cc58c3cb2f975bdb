"""Port inverse DWT (ffmpeg_ht_tpu_torch.ops.dwt_torch): 5/3, 9/7 int, 9/7 float.

Subband arrays made from a numpy seed go through the port's
``dwt_decode_bands``, the JAX ``dwt_jax.dwt_decode_bands`` and, assembled
into the quadrant pyramid, the numpy oracle ``ops/dwt.dwt_decode``; the
pyramid also goes through the port's flat fallback ``dwt_decode_flat`` and
the JAX ``dwt_jax._dwt_decode_traced`` on borders with a level below 8x8.
The integer transforms must be equal everywhere (exact). The float 9/7
must equal the numpy oracle exactly (same float32 op order, one rounding
per op) and lie within 1e-3 of the jitted JAX function on inputs
|x| <= 600: XLA may contract a multiply and an add into one FMA. Observed
maximum against JAX: 7.3e-4 (band-direct), 4.9e-4 (flat).
"""

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ffmpeg_ht_tpu.ops import dwt as dwt_np
from ffmpeg_ht_tpu.ops import dwt_jax
from ffmpeg_ht_tpu_torch.ops import dwt_torch

# ((x0, x1), (y0, y1)) borders with odd origins / ends, 2-4 levels
CASES = [
    (((0, 64), (0, 48)), 2),
    (((3, 70), (5, 58)), 3),
    (((1, 130), (2, 97)), 4),
    (((7, 140), (0, 135)), 4),
]


# borders whose lowest level is below 8x8 (5x5; 7x14)
FLAT_CASES = [(((0, 20), (0, 20)), 3), (((1, 30), (0, 64)), 3)]
T97 = {"int": dwt_np.DWT97_INT, "float": dwt_np.DWT97}
T_ALL = dict(T97, **{"53": dwt_np.DWT53})


def _bands(border, ndec, rng):
    """Random ll + per-level (hl, lh, hh) for `border`, and the pyramid."""
    linelen, mod = dwt_np.dwt_levels(border, ndec)
    nl = lambda ln, m: len(range(m, ln, 2))
    (lh0, lv0), (mh0, mv0) = linelen[0], mod[0]
    rnd = lambda shape: rng.integers(-600, 600, shape).astype(np.int32)
    ll = rnd((nl(lv0, mv0), nl(lh0, mh0)))
    levels = []
    for (lh, lv), (mh, mv) in zip(linelen, mod):
        nlh, nlv = nl(lh, mh), nl(lv, mv)
        levels.append((rnd((nlv, lh - nlh)), rnd((lv - nlv, nlh)),
                       rnd((lv - nlv, lh - nlh))))
    lh, lv = linelen[-1]
    pyr = np.zeros((lv, lh), np.int32)
    p = ll
    for (lh, lv), (mh, mv), (hl, lhb, hh) in zip(linelen, mod, levels):
        nlh, nlv = nl(lh, mh), nl(lv, mv)
        pyr[:nlv, :nlh] = p
        pyr[:nlv, nlh:lh] = hl
        pyr[nlv:lv, :nlh] = lhb
        pyr[nlv:lv, nlh:lh] = hh
        p = pyr[:lv, :lh]
    return ll, levels, pyr


@pytest.mark.parametrize("border,ndec", CASES)
def test_dwt_bands_match_jax_and_oracle(border, ndec):
    b = [list(border[0]), list(border[1])]
    assert dwt_torch.dwt_poly_capable(b, ndec)
    assert dwt_jax.dwt_poly_capable(b, ndec)
    ll, levels, pyr = _bands(border, ndec, np.random.default_rng(ndec * 31))
    got = dwt_torch.dwt_decode_bands(
        torch.from_numpy(ll),
        [tuple(torch.from_numpy(a) for a in lvl) for lvl in levels],
        b, ndec, dwt_np.DWT53)
    fn = jax.jit(lambda ll, lv: dwt_jax.dwt_decode_bands(
        ll, lv, b, ndec, dwt_np.DWT53))
    want_jax = fn(jnp.asarray(ll), [tuple(jnp.asarray(a) for a in lvl)
                                    for lvl in levels])
    want_np = dwt_np.dwt_decode(pyr.copy(), b, ndec, dwt_np.DWT53)
    assert got.dtype == torch.int32
    assert got.shape == (border[1][1] - border[1][0],
                         border[0][1] - border[0][0])
    assert np.array_equal(got.numpy(), np.asarray(want_jax))
    assert np.array_equal(got.numpy(), want_np)


def _as(a, transform):
    return a.astype(np.float32 if transform == dwt_np.DWT97 else np.int32)


def _check(got, want_jax, want_np, transform):
    if transform == dwt_np.DWT97:
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), want_np)
        assert np.abs(got.numpy() - want_jax).max() <= 1e-3
    else:
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want_jax)
        assert np.array_equal(got.numpy(), want_np)


@pytest.mark.parametrize("tname", list(T97))
@pytest.mark.parametrize("border,ndec", CASES)
def test_dwt97_bands_match_jax_and_oracle(border, ndec, tname):
    t = T97[tname]
    b = [list(border[0]), list(border[1])]
    ll, levels, pyr = _bands(border, ndec, np.random.default_rng(ndec * 37))
    ll, pyr = _as(ll, t), _as(pyr, t)
    levels = [tuple(_as(a, t) for a in lvl) for lvl in levels]
    got = dwt_torch.dwt_decode_bands(
        torch.from_numpy(ll),
        [tuple(torch.from_numpy(a) for a in lvl) for lvl in levels],
        b, ndec, t)
    fn = jax.jit(lambda ll, lv: dwt_jax.dwt_decode_bands(ll, lv, b, ndec, t))
    want_jax = np.asarray(fn(jnp.asarray(ll), [
        tuple(jnp.asarray(a) for a in lvl) for lvl in levels]))
    assert got.shape == (border[1][1] - border[1][0],
                         border[0][1] - border[0][0])
    _check(got, want_jax, dwt_np.dwt_decode(pyr.copy(), b, ndec, t), t)


@pytest.mark.parametrize("tname", list(T_ALL))
@pytest.mark.parametrize("border,ndec", FLAT_CASES)
def test_dwt_flat_matches_jax_and_oracle(border, ndec, tname):
    """The flat fallback on geometries with a level below 8x8: the
    interleaved line buffer there, the polyphase sweep on larger levels."""
    t = T_ALL[tname]
    b = [list(border[0]), list(border[1])]
    assert not dwt_torch.dwt_poly_capable(b, ndec)
    _ll, _levels, pyr = _bands(border, ndec, np.random.default_rng(ndec))
    pyr = _as(pyr, t)
    src = torch.from_numpy(pyr.copy())
    got = dwt_torch.dwt_decode_flat(src, b, ndec, t)
    assert np.array_equal(src.numpy(), pyr)          # input left as it was
    fn = jax.jit(lambda d: dwt_jax._dwt_decode_traced(d, b, ndec, t))
    _check(got, np.asarray(fn(jnp.asarray(pyr))),
           dwt_np.dwt_decode(pyr.copy(), b, ndec, t), t)


def test_poly_capable_matches_jax_and_97_raises():
    """dwt_poly_capable agrees with the JAX package's; the band-direct
    entry takes every transform and raises for every one (9/7 included)
    on a border with a level below 8x8, which belongs to the flat
    fallback."""
    for border, ndec in CASES + FLAT_CASES + [(((0, 20), (0, 20)), 2)]:
        b = [list(border[0]), list(border[1])]
        assert dwt_torch.dwt_poly_capable(b, ndec) == \
            dwt_jax.dwt_poly_capable(b, ndec)
    for border, ndec in FLAT_CASES:
        ll, levels, _ = _bands(border, ndec, np.random.default_rng(0))
        for t in T_ALL.values():
            with pytest.raises(ValueError, match="dwt_decode_flat"):
                dwt_torch.dwt_decode_bands(
                    torch.from_numpy(_as(ll, t)),
                    [tuple(torch.from_numpy(_as(a, t)) for a in lvl)
                     for lvl in levels],
                    [list(border[0]), list(border[1])], ndec, t)
