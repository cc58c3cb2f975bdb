"""The v3 program's coefficient stages in the port vs the JAX package.

``ops/coef_cuda.coef_mosaic`` (dequant + prefill + band mosaic; on the
CPU its plain version ``coef_mosaic_ref``) against the JAX package's own
functions on the same numpy inputs: its host dequant per lane
(``ops/dequant.dequant_int`` / ``dequant_int_97`` / ``dequant_float``,
which the JAX program's dequant is held to), the JAX program's prefill
(``.at[pf_idx].set(pf_val, mode="drop")``) and its eager ``_mosaic_band``
(``ffmpeg_ht_tpu/models/assembly.py:200``), band by band, on assembly
plans whose codeblocks are cut by precincts and cropped. The inputs come
from one ``np.random.default_rng`` seed: every mu word, the per-lane
magb, istep, step sizes (hence scale97 and fscale), and prefill entries
that include pads and entries outside a codeblock's crop. Two frames of
lanes, each with pad lanes past the plan's. Exact for every transform.
The map table that the card's kernel reads (``CoefLayout.table``) is
held to the same bands by a numpy scatter through it.

``ops/dwt_cuda.dwt_lift`` (on the CPU its plain version
``dwt_torch.dwt_level_ref``, one level) driven level by level against
the JAX ``dwt_jax.dwt_decode_bands`` and the numpy oracle
``ops/dwt.dwt_decode`` on the assembled pyramid, for 5/3, integer 9/7 and
float 9/7, on borders with odd origins (mh, mv = 1) and one whose lowest
level is the 8x8 minimum. Exact for 5/3 and integer 9/7; float 9/7 equal
to the numpy oracle and within 1e-3 of JAX (XLA may contract a multiply
and an add into one FMA; tests/test_torch_dwt.py states the same rule).
No JAX v3 or v2 program is compiled here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffmpeg_ht_tpu.codestream.parser import parse_codestream as jax_parse
from ffmpeg_ht_tpu.models import assembly as jax_asm
from ffmpeg_ht_tpu.models import fastpath as jax_fp
from ffmpeg_ht_tpu.ops import dequant as jax_dq
from ffmpeg_ht_tpu.ops import dwt as dwt_np
from ffmpeg_ht_tpu.ops import dwt_jax
from ffmpeg_ht_tpu_torch.codestream.parser import parse_codestream
from ffmpeg_ht_tpu_torch.models import assembly as ASM
from ffmpeg_ht_tpu_torch.models import fastpath as FP
from ffmpeg_ht_tpu_torch.models.encoder import encode_frame_htj2k
from ffmpeg_ht_tpu_torch.ops import coef_cuda, dwt_cuda

T = {"53": dwt_np.DWT53, "int": dwt_np.DWT97_INT, "float": dwt_np.DWT97}
# geometries whose codeblocks precincts cut (rasters wider than the
# blocks) and crop (a last block row or column inside a precinct)
GEOMS = {
    "gray-32x32": ((90, 118), dict(log2_cblk_width=5, log2_cblk_height=5)),
    "rgb-16x16": ((75, 101, 3), dict(log2_cblk_width=4, log2_cblk_height=4,
                                     mct=True)),
}
F, PADS = 2, 3            # frames of lanes; pad lanes after each frame's


def _plans(geom):
    """(the JAX package's plan, the port's plan, the port's geometry key)
    of one encoded stream."""
    shape, opts = GEOMS[geom]
    img = np.random.default_rng(7).integers(0, 256, shape, dtype=np.uint8)
    data = encode_frame_htj2k(img, nreslevels=3, log2_prec_width=6, **opts)
    jfg = jax_fp.FlatGeometry(jax_parse(data, bitexact=True))
    fg = FP.FlatGeometry(parse_codestream(data, bitexact=True))
    return jax_asm.build_plan(jfg), ASM.build_plan(fg), fg.geom.key()


def _lane_inputs(rng, N, bh, bw, transform):
    """mu words and per-lane vectors, and the JAX package's per-lane
    dequant of them (numpy, (N, bh, bw))."""
    mu = rng.integers(0, 1 << 32, (N, bh, bw), dtype=np.uint64) \
        .astype(np.uint32).view(np.int32)
    magb = rng.integers(4, 15, N).astype(np.int32)
    istep = np.where(rng.random(N) < 0.5, 32768,
                     rng.integers(1000, 65536, N)).astype(np.int32)
    fstep = rng.uniform(0.25, 4.0, N).astype(np.float32)
    scale97 = np.array([jax_dq.int97_scale(s, m)
                        for s, m in zip(fstep, magb)], np.int32)
    fscale = np.array([np.float32(s) / np.float32(1 << (31 - m))
                       for s, m in zip(fstep, magb)], np.float32)
    if transform == dwt_np.DWT53:
        ref = [jax_dq.dequant_int(mu[i], int(istep[i]), int(magb[i]))
               for i in range(N)]
    elif transform == dwt_np.DWT97_INT:
        ref = [jax_dq.dequant_int_97(mu[i], float(fstep[i]), int(magb[i]))
               for i in range(N)]
    else:
        ref = [jax_dq.dequant_float(mu[i], float(fstep[i]), int(magb[i]))
               for i in range(N)]
    return (mu, magb, istep, scale97, fscale), np.stack(ref)


def _prefill_entries(rng, layout, n, dtype):
    """n prefill entries: samples of lanes just outside their crop, random
    lane-raster samples, and three pads (one past the rasters)."""
    N, bh, bw = layout.n_lanes, layout.bh, layout.bw
    t = layout.table
    outside = np.array([lane * bh * bw + y * bw + x for lane in range(N)
                        for y, x in ((t[lane, 4], 0), (0, t[lane, 5]))
                        if t[lane, 4] and y < bh and x < bw][:n // 4],
                       np.int64)
    rest = np.setdiff1d(np.arange(N * bh * bw), outside)
    picks = rng.choice(rest, n - 3 - len(outside), replace=False)
    idx = np.concatenate([outside, picks, [N * bh * bw] * 3])
    val = rng.integers(-3000, 3000, n).astype(dtype)
    return idx.astype(np.int32), val, len(outside)


def _table_mosaic(ras, layout, pf_idx, pf_val):
    """The kernel's addressing in numpy: each lane's cropped raster to
    ``off + (by0 + y) * band_w + bx0 + x``, then the prefill entries
    through the same table (pads and samples outside a crop dropped)."""
    out = np.zeros(layout.total, ras.dtype)
    for lane, (off, bw_, by0, bx0, h, w) in enumerate(layout.table):
        if h and w:
            y, x = np.mgrid[:h, :w]
            out[off + (by0 + y) * bw_ + bx0 + x] = ras[lane, :h, :w]
    span = layout.bh * layout.bw
    for i, v in zip(pf_idx, pf_val):
        if i >= layout.n_lanes * span:
            continue
        lane, r = divmod(int(i), span)
        y, x = divmod(r, layout.bw)
        off, bw_, by0, bx0, h, w = layout.table[lane]
        if y < h and x < w:
            out[off + (by0 + y) * bw_ + bx0 + x] = v
    return out


@pytest.mark.parametrize("tname", list(T))
@pytest.mark.parametrize("geom", list(GEOMS))
def test_coef_mosaic_ref_matches_jax(geom, tname):
    transform = T[tname]
    jplan, plan, key = _plans(geom)
    n_pad = plan.n_lanes + PADS
    prog = ASM.V3Program(plan, key[:-1] + (transform,), qw=plan.bw // 2,
                         qh=plan.bh // 2, ms_class=8, n_pad=n_pad, frames=F,
                         layout=ASM.FrameLayout.identity(key))
    assert prog.band_direct
    layout = prog.layout
    assert layout.n_lanes == F * n_pad
    assert any(pp.blk_w < plan.bw or pp.blk_h < plan.bh
               for p in plan.planes
               for bp in (p.levels[0], *sum(p.levels[1], ()))
               for row in bp.rows for pp in row)
    rng = np.random.default_rng([list(GEOMS).index(geom),
                                 list(T).index(tname)])
    N, bh, bw = layout.n_lanes, layout.bh, layout.bw
    lanes, ref = _lane_inputs(rng, N, bh, bw, transform)
    dtype = np.float32 if transform == dwt_np.DWT97 else np.int32
    pf_idx, pf_val, n_outside = _prefill_entries(rng, layout, 64, dtype)
    assert n_outside and (pf_idx == N * bh * bw).sum() == 3

    got = coef_cuda.coef_mosaic(
        *(torch.from_numpy(a) for a in lanes), torch.from_numpy(pf_idx),
        torch.from_numpy(pf_val), layout, transform,
        no_istep=False).numpy()
    assert got.dtype == dtype and got.shape == (layout.total,)

    # the JAX side: the prefill as the JAX program runs it, then its
    # _mosaic_band over the JAX plan's bands in the layout's order
    ras = jnp.asarray(ref.astype(dtype)).reshape(-1).at[pf_idx].set(
        pf_val, mode="drop").reshape(ref.shape)
    jbands = []
    for f in range(F):
        for plane in jplan.planes:
            ll, lvls = plane.levels
            for bp in (ll, *(b for lvl in lvls for b in lvl)):
                jbands.append(np.asarray(jax_asm._mosaic_band(
                    ras, bp, f * n_pad, ras.dtype)))
    views = layout.views(torch.from_numpy(got))
    assert len(views) == len(jbands)
    for v, want in zip(views, jbands):
        assert v.shape == want.shape
        assert np.array_equal(v.numpy(), want)
    # the map table the kernel reads places every sample the same way
    assert np.array_equal(
        _table_mosaic(ref.astype(dtype), layout, pf_idx, pf_val), got)


def _bands(border, ndec, rng, transform):
    """Random ll + per-level (hl, lh, hh) for `border`, and the pyramid."""
    linelen, mod = dwt_np.dwt_levels(border, ndec)
    nl = lambda ln, m: len(range(m, ln, 2))
    dt = np.float32 if transform == dwt_np.DWT97 else np.int32
    rnd = lambda shape: rng.integers(-600, 600, shape).astype(dt)
    (lh0, lv0), (mh0, mv0) = linelen[0], mod[0]
    ll = rnd((nl(lv0, mv0), nl(lh0, mh0)))
    levels = []
    for (lh, lv), (mh, mv) in zip(linelen, mod):
        nlh, nlv = nl(lh, mh), nl(lv, mv)
        levels.append((rnd((nlv, lh - nlh)), rnd((lv - nlv, nlh)),
                       rnd((lv - nlv, lh - nlh))))
    lh, lv = linelen[-1]
    pyr = np.zeros((lv, lh), dt)
    p = ll
    for (lh, lv), (mh, mv), (hl, lhb, hh) in zip(linelen, mod, levels):
        nlh, nlv = nl(lh, mh), nl(lv, mv)
        pyr[:nlv, :nlh] = p
        pyr[:nlv, nlh:lh] = hl
        pyr[nlv:lv, :nlh] = lhb
        pyr[nlv:lv, nlh:lh] = hh
        p = pyr[:lv, :lh]
    return ll, levels, pyr


# ((x0, x1), (y0, y1)) borders: odd origins on both axes at every level,
# the lowest level exactly 8x8, an odd origin across and an odd end down
LIFT_CASES = [(((1, 41), (3, 43)), 3), (((0, 32), (0, 32)), 3),
              (((3, 70), (0, 37)), 2)]


@pytest.mark.parametrize("tname", list(T))
@pytest.mark.parametrize("border,ndec", LIFT_CASES)
def test_dwt_lift_ref_matches_jax_and_oracle(border, ndec, tname):
    t = T[tname]
    b = [list(border[0]), list(border[1])]
    linelen, mod = dwt_np.dwt_levels(b, ndec)
    assert min(min(ln) for ln in linelen) >= 8
    ll, levels, pyr = _bands(border, ndec, np.random.default_rng(ndec), t)
    p = torch.from_numpy(ll)
    for lev, (lvl, (mh, mv)) in enumerate(zip(levels, mod)):
        (p,) = dwt_cuda.dwt_lift(
            [(p, *map(torch.from_numpy, lvl), mh, mv,
              t == dwt_np.DWT97_INT and lev == ndec - 1)], t)
    assert p.shape == (border[1][1] - border[1][0],
                       border[0][1] - border[0][0])
    want_np = dwt_np.dwt_decode(pyr.copy(), b, ndec, t)
    want_jax = np.asarray(jax.jit(
        lambda ll, lv: dwt_jax.dwt_decode_bands(ll, lv, b, ndec, t))(
            jnp.asarray(ll), [tuple(map(jnp.asarray, lvl))
                              for lvl in levels]))
    assert np.array_equal(p.numpy(), want_np)
    if t == dwt_np.DWT97:
        assert p.dtype == torch.float32
        assert np.abs(p.numpy() - want_jax).max() <= 1e-3
    else:
        assert p.dtype == torch.int32
        assert np.array_equal(p.numpy(), want_jax)


def test_dwt_lift_refuses_what_is_not_a_band_direct_level():
    """A level below 8x8 belongs to the flat fallback, and bands that do
    not split a level at the given parities are refused, on either
    device, before anything is computed."""
    z = lambda h, w: torch.zeros((h, w), dtype=torch.int32)
    with pytest.raises(ValueError, match="dwt_decode_flat"):
        dwt_cuda.dwt_lift([(z(4, 4), z(4, 3), z(3, 4), z(3, 3), 0, 0,
                            False)], dwt_np.DWT53)
    with pytest.raises(ValueError, match="split"):
        dwt_cuda.dwt_lift([(z(8, 8), z(8, 7), z(8, 8), z(8, 7), 1, 0,
                            False)], dwt_np.DWT53)
    with pytest.raises(ValueError, match="preshift"):
        dwt_cuda.dwt_lift([(z(8, 8), z(8, 8), z(8, 8), z(8, 8), 0, 0,
                            True)], dwt_np.DWT53)
    with pytest.raises(TypeError, match="dtype"):
        dwt_cuda.dwt_lift([(z(8, 8), z(8, 8), z(8, 8), z(8, 8), 0, 0,
                            False)], dwt_np.DWT97)
