"""Port RCT write-frame (ffmpeg_ht_tpu_torch.ops.mct_cuda) vs the JAX one.

``rct_writeframe_ref`` must equal the Pallas kernel
``ffmpeg_ht_tpu.ops.mct_pallas.rct_writeframe`` (interpret mode) and its
jnp reference exactly, for every sample depth the v3 packed output takes,
including negative chroma (arithmetic ``>>`` on negative int32).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ffmpeg_ht_tpu.ops import mct_pallas
from ffmpeg_ht_tpu_torch.ops import mct_cuda


def _planes(cbps, seed):
    rng = np.random.default_rng(seed)
    lo, hi = -(1 << (cbps - 1)), 1 << (cbps - 1)
    y0 = rng.integers(lo, hi, (24, 40)).astype(np.int32)
    y1 = rng.integers(2 * lo, 2 * hi, (24, 40)).astype(np.int32)
    y2 = rng.integers(2 * lo, 2 * hi, (24, 40)).astype(np.int32)
    # pin the arithmetic shift: (y2 + y1) = -5 -> -2, not -1
    y1[0, 0], y2[0, 0] = -2, -3
    assert (y1 < 0).any() and (y2 < 0).any()
    return y0, y1, y2


@pytest.mark.parametrize("cbps", [8, 10, 12, 16])
def test_rct_ref_matches_pallas(cbps):
    y = _planes(cbps, seed=cbps)
    want = mct_pallas.rct_writeframe(*(jnp.asarray(a) for a in y), cbps,
                                     interpret=True)
    want_ref = mct_pallas.rct_writeframe_ref(*(jnp.asarray(a) for a in y),
                                             cbps)
    got = mct_cuda.rct_writeframe_ref(*(torch.from_numpy(a) for a in y),
                                      cbps)
    for w, wr, g in zip(want, want_ref, got):
        assert g.dtype == torch.int32
        assert np.array_equal(np.asarray(w), g.numpy())
        assert np.array_equal(np.asarray(wr), g.numpy())
    g = y[0][0, 0] - ((y[2][0, 0] + y[1][0, 0]) >> 2)
    assert got[1][0, 0] == min(max(g + (1 << (cbps - 1)), 0),
                               (1 << cbps) - 1)


@pytest.mark.parametrize("cbps", [8, 10, 12, 16])
def test_rct_wrapper_packs_on_cpu(cbps):
    """The wrapper on CPU tensors: the plain version, then the narrowing
    copy into the packed slice (uint16 samples as int16 bits); no kernel
    launch."""
    y = [torch.from_numpy(a) for a in _planes(cbps, seed=100 + cbps)]
    ref = mct_cuda.rct_writeframe_ref(*y, cbps)
    before = mct_cuda.rct_writeframe.launches
    planes = mct_cuda.rct_writeframe(*y, cbps)
    assert all(torch.equal(a, b) for a, b in zip(planes, ref))
    dtype = torch.uint8 if cbps <= 8 else torch.int16
    out = torch.full((3 * y[0].numel(),), 7, dtype=dtype)
    assert mct_cuda.rct_writeframe(*y, cbps, out=out) is out
    assert mct_cuda.rct_writeframe.launches == before
    host = out.numpy().view(np.uint16) if cbps > 8 else out.numpy()
    assert np.array_equal(host.astype(np.int64),
                          torch.stack(ref).reshape(-1).numpy())
    with pytest.raises(ValueError):
        mct_cuda.rct_writeframe(*y, cbps, out=out[1:])


# ---------------------------------------------------------------------------
# ICT (9/7 frames with MCT)
# ---------------------------------------------------------------------------
#
# The JAX package computes the ICT tail inside make_v3_program as closures
# (ffmpeg_ht_tpu/models/assembly.py:390-408), which cannot be imported;
# _jax_ict below is those lines verbatim, run with jnp on the same inputs.
# The whole JAX program, closures included, is held against the port on
# ICT streams in tests/test_torch_decoder97.py.

from ffmpeg_ht_tpu.ops import mct as jax_pkg_mct  # noqa: E402
from ffmpeg_ht_tpu_torch.ops import mct as port_mct  # noqa: E402
from ffmpeg_ht_tpu_torch.ops.dwt import DWT97, DWT97_INT  # noqa: E402


def _jax_ict(y, cbps, transform):
    shift = 1 << (cbps - 1)

    def finish(c):
        if transform == DWT97:
            c = jnp.rint(c).astype(jnp.int32)
        return jnp.clip(c + shift, 0, (1 << cbps) - 1)

    def ict_int(y0, y1, y2):
        def qmul(c, v):
            prod = jnp.uint32(c & 0xFFFFFFFF) * v.astype(jnp.uint32)
            prod = prod + jnp.uint32(1 << 15)
            return prod.astype(jnp.int32) >> 16
        i0 = y0 + y2 + qmul(26345, y2)
        i1 = y0 - qmul(22553, y1) - qmul(46802, y2)
        i2 = y0 + 2 * y1 + qmul(-14942, y1)
        return i0, i1, i2

    def ict_float(y0, y1, y2):
        fv = [jnp.float32(v) for v in (1.402, 0.34413, 0.71414, 1.772)]
        return (y0 + fv[0] * y2, y0 - fv[1] * y1 - fv[2] * y2,
                y0 + fv[3] * y1)

    ict = ict_float if transform == DWT97 else ict_int
    return [np.asarray(finish(c))
            for c in ict(*(jnp.asarray(a) for a in y))]


def _ict_planes(transform, cbps, seed):
    """Three (24, 40) planes around the sample range; the int planes'
    last rows reach +-2^31 so every Q16 product and 2*y1 wraps, the float
    planes carry exact .5 ties."""
    rng = np.random.default_rng(seed)
    lim = 1 << (cbps + 1)
    y = [rng.integers(-lim, lim, (24, 40)) for _ in range(3)]
    if transform == DWT97_INT:
        for a in y:
            a[-2:] = rng.integers(-2 ** 31, 2 ** 31, (2, 40))
        return [a.astype(np.int32) for a in y]
    y = [(a / 2 + rng.random((24, 40)) * (rng.random() < 0.5))
         .astype(np.float32) for a in y]
    y[1][0, :8] = y[2][0, :8] = 0
    y[0][0, :8] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 63.5]
    return y


@pytest.mark.parametrize("cbps", [8, 12])
@pytest.mark.parametrize("transform", [DWT97_INT, DWT97])
def test_ict_ref_matches_jax(transform, cbps):
    """int: exact against the JAX closures and the numpy ops/mct.ict_int
    of both packages, products wrapping included. float: within 1 LSB of
    the JAX closures (XLA may fuse a multiply-add into one FMA) and exact
    against numpy ops/mct.ict_float + rint (one rounding per op)."""
    y = _ict_planes(transform, cbps, seed=cbps + 10 * transform)
    got = mct_cuda.ict_writeframe_ref(*(torch.from_numpy(a) for a in y),
                                      cbps, transform)
    want_jax = _jax_ict(y, cbps, transform)
    lo, hi = 0, (1 << cbps) - 1
    if transform == DWT97_INT:
        mods = (jax_pkg_mct, port_mct)
        fin = lambda c: np.clip(c.astype(np.int64) + (1 << (cbps - 1)),
                                lo, hi)
    else:
        mods = (port_mct,)
        fin = lambda c: np.clip(np.rint(c).astype(np.int64)
                                + (1 << (cbps - 1)), lo, hi)
    for i, g in enumerate(got):
        assert g.dtype == torch.int32
        d = np.abs(g.numpy().astype(np.int64) - want_jax[i])
        assert d.max() <= (0 if transform == DWT97_INT else 1)
        for mod in mods:
            c = (mod.ict_int if transform == DWT97_INT else mod.ict_float)(*y)
            assert np.array_equal(g.numpy(), fin(c[i])), (mod.__name__, i)
    if transform == DWT97:                      # half-to-even ties
        assert got[0][0, :8].tolist() == [
            v + (1 << (cbps - 1)) for v in (0, 2, 2, 0, -2, -2, 4, 64)]


@pytest.mark.parametrize("transform", [DWT97_INT, DWT97])
def test_ict_wrapper_packs_on_cpu(transform):
    """The wrapper on CPU tensors: the plain version per frame, then the
    narrowing copy into each frame's packed slice (frame_stride apart);
    no kernel launch; bad arguments raise."""
    for cbps in (8, 10):
        frames = [[torch.from_numpy(a) for a in
                   _ict_planes(transform, cbps, seed)] for seed in (3, 4)]
        ref = [mct_cuda.ict_writeframe_ref(*y, cbps, transform)
               for y in frames]
        before = mct_cuda.ict_writeframe.launches
        planes = mct_cuda.ict_writeframe(frames, cbps, transform)
        assert all(torch.equal(a, b) for p, r in zip(planes, ref)
                   for a, b in zip(p, r))
        n = frames[0][0].numel()
        stride = 3 * n + 5
        dtype = torch.uint8 if cbps <= 8 else torch.int16
        out = torch.full((stride + 3 * n,), 7, dtype=dtype)
        assert mct_cuda.ict_writeframe(frames, cbps, transform, out=out,
                                       frame_stride=stride) is out
        assert mct_cuda.ict_writeframe.launches == before
        host = out.numpy().view(np.uint16) if cbps > 8 else out.numpy()
        for f in range(2):
            assert np.array_equal(
                host[f * stride:f * stride + 3 * n].astype(np.int64),
                torch.stack(ref[f]).reshape(-1).numpy())
        assert (host[3 * n:stride] == 7).all()      # the gap is left alone
    y = frames[0]
    with pytest.raises(ValueError):             # 9 bits into uint8
        mct_cuda.ict_writeframe([y], 9, transform,
                                out=torch.empty(3 * n, dtype=torch.uint8))
    with pytest.raises(ValueError):             # out too short for 2 frames
        mct_cuda.ict_writeframe(frames, 10, transform, out=out[1:],
                                frame_stride=stride)
    with pytest.raises(TypeError):
        mct_cuda.ict_writeframe([[t.to(torch.float64) for t in y]], 8,
                                transform)
    with pytest.raises(ValueError):
        mct_cuda.ict_writeframe([y], 8, 1)      # 5/3 takes RCT
