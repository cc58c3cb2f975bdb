"""The flat-buffer DWT plan, the v2 scatter and the plane write-out on the
CPU.

The port runs a flat quadrant pyramid's inverse DWT (the v2
``BucketProgram``'s planes, and a ``V3Program`` with a level under 8x8)
through one ``LiftPlan``: levels under 8 in a dimension as small jobs
(``dwt_level_small_ref``, the kernel ``csrc/dwt_small.cu`` on the card),
the others as strided ``dwt_level_ref`` jobs on the planes' corners. Its
plain route must equal ``dwt_decode_flat`` and the JAX package's
``_dwt_decode_traced`` by bits. ``bucket_scatter_ref`` and the plan, fed
the same mu words as the JAX ``_compiled_assembly``, must give its packed
output (the prefill under a lane sample loses to the lane in both).
``plane_writeframe_ref`` rounds, shifts, clips and narrows as the JAX
``finish``. A layered stream whose lowest level is under 8x8 must decode
through ``Decoder(device="cpu")`` on the v2 path to the host oracle's
bytes. One small JAX geometry is compiled, no JAX stream decode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffmpeg_ht_tpu.models import decoder as jax_decoder
from ffmpeg_ht_tpu.ops import dwt_jax
from ffmpeg_ht_tpu_torch.models import assembly as port_asm
from ffmpeg_ht_tpu_torch.models import decoder as port_decoder
from ffmpeg_ht_tpu_torch.models import fastpath as port_fp
from ffmpeg_ht_tpu_torch.models import host_decoder as port_host
from ffmpeg_ht_tpu_torch.models.decoder import Decoder
from ffmpeg_ht_tpu_torch.models.encoder import encode_frame_htj2k
from ffmpeg_ht_tpu_torch.ops import coef_cuda, dwt_cuda, dwt_torch, mct_cuda
from ffmpeg_ht_tpu_torch.ops.dwt import DWT53, DWT97, DWT97_INT, dwt_decode

TRANSFORMS = {"53": DWT53, "int": DWT97_INT, "float": DWT97}


def _dtype(t):
    return torch.float32 if t == DWT97 else torch.int32


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _plan_route(data, border, ndec, t):
    """The plain plan route on one (H, W) quadrant pyramid: the plane's
    flat LiftPlan through ``dwt_lift_program_ref``; the plane after it."""
    h, w = data.shape
    plan = port_asm.flat_lift_plan([(0, h, w)], [border], [ndec], t,
                                   h * w + 1)
    flat = torch.cat([data.reshape(-1), data.new_zeros(1)])
    scratch = dwt_cuda.dwt_lift_program_ref(plan, flat)
    last = plan.last[0]
    return (data if last is None else plan.view(scratch, last)), plan


def _random_plane(rng, h, w, t):
    return torch.from_numpy(rng.integers(-3000, 3000, (h, w))).to(_dtype(t))


@pytest.mark.parametrize("x0,y0", [(0, 0), (1, 0), (0, 1), (1, 1)])
@pytest.mark.parametrize("tname", list(TRANSFORMS))
def test_plan_route_equals_dwt_decode_flat(tname, x0, y0):
    """Planes with a side of 1-7 against the other of 1-9 and 33 (both
    ways) and 1-3 levels, so that the first two levels of some are under
    8x8 and some levels are empty, and a 5x70000 plane: the plan route
    equals ``dwt_decode_flat`` by bits."""
    t = TRANSFORMS[tname]
    rng = np.random.default_rng(10 * x0 + y0 + len(tname))
    sizes = [(a, b) for a in range(1, 8) for b in list(range(1, 10)) + [33]]
    cases = [((w, h), n) for a, b in sizes for w, h in ((a, b), (b, a))
             for n in (1, 2, 3)] + [((70000, 5), 1), ((5, 70000), 2)]
    small = 0
    for (w, h), ndec in cases:
        border = ((x0, x0 + w), (y0, y0 + h))
        data = _random_plane(rng, h, w, t)
        want = dwt_torch.dwt_decode_flat(data, [list(b) for b in border],
                                         ndec, t)
        got, plan = _plan_route(data, border, ndec, t)
        small += len(plan.small_table)
        assert torch.equal(_bits(got), _bits(want)), (w, h, ndec)
    assert small > len(cases)             # planes of two small levels too


@pytest.mark.parametrize("tname", list(TRANSFORMS))
def test_plan_route_equals_jax_dwt_decode_traced(tname):
    """The plan route against the JAX flat inverse DWT (XLA ops) on a
    plane with two levels under 8x8 and one with a 7-row level: equal by
    bits for 5/3 and the integer 9/7; for the float 9/7 equal by bits to
    the numpy reference (ops/dwt.dwt_decode) and within 1e-6 of the
    largest sample (a few float32 ulps of these +-8000 samples) of the
    JAX function, whose CPU compile contracts multiply-adds into FMAs,
    one rounding fewer a step."""
    t = TRANSFORMS[tname]
    rng = np.random.default_rng(30 + len(tname))
    for border, ndec in ((((1, 27), (3, 16)), 3), (((0, 70), (1, 8)), 2)):
        h = border[1][1] - border[1][0]
        w = border[0][1] - border[0][0]
        data = _random_plane(rng, h, w, t)
        b = [list(border[0]), list(border[1])]
        want = np.asarray(jax.jit(
            lambda d: dwt_jax._dwt_decode_traced(d, b, ndec, t))(
                jnp.asarray(data.numpy())))
        got, plan = _plan_route(data, border, ndec, t)
        assert len(plan.small_table)
        if t == DWT97:
            assert np.array_equal(got.numpy(), dwt_decode(
                data.numpy().copy(), b, ndec, t))
            assert np.abs(got.numpy() - want).max() \
                <= 1e-6 * np.abs(want).max()
        else:
            assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("tname", list(TRANSFORMS))
def test_small_level_ref_equals_the_flat_branch(tname):
    """``dwt_level_small_ref`` on a level's four bands (cut from a
    one-level pyramid) equals ``dwt_decode_flat`` on the pyramid, for
    every level shape under 8x8 up to 7x9 at every parity, the integer
    9/7's shift included."""
    t = TRANSFORMS[tname]
    rng = np.random.default_rng(40 + len(tname))
    for mh in (0, 1):
        for mv in (0, 1):
            for w in range(1, 10):
                for h in range(1, 8):
                    for lw, lh in ((w, h), (h, w)):
                        border = [[mh, mh + lw], [mv, mv + lh]]
                        data = _random_plane(rng, lh, lw, t)
                        nE, nEv = (lw + 1 - mh) // 2, (lh + 1 - mv) // 2
                        got = dwt_torch.dwt_level_small_ref(
                            data[:nEv, :nE], data[:nEv, nE:],
                            data[nEv:, :nE], data[nEv:, nE:], mh, mv, t,
                            t == DWT97_INT)
                        want = dwt_torch.dwt_decode_flat(data, border, 1, t)
                        assert torch.equal(_bits(got), _bits(want))


# a layered 96x128 10-bit gray stream with 32x32 codeblocks and 6
# resolution levels: the v2 path, its lowest DWT level 8x6
LAYERED = dict(nreslevels=6, log2_cblk_width=5, log2_cblk_height=5,
               refinement=True, ht_layers=2)
GRAY10 = np.random.default_rng(20261020).integers(0, 1024, (96, 128)) \
    .astype(np.uint16)
STREAM = encode_frame_htj2k(GRAY10, depth=10, **LAYERED)


def _bucket_inputs():
    """The v2 program of STREAM (the port's flat lane) with random mu
    words: (geometry, shapes, numpy bucket arrays, pf_idx, pf_val, mus),
    the prefill's first entry moved under a real lane's first sample."""
    dec = Decoder(device="cpu")
    hdr = dec._parse(STREAM)
    fg = dec._fast_geom(hdr)
    geom, (shapes, bargs, pf_idx, pf_val), _acc = dec._v2_args(
        fg, [port_fp.parse_frame_flat(hdr, fg)])
    rng = np.random.default_rng(7)
    mus = [(rng.integers(0, 1 << 14, (a["dest"].shape[0], 2 * qh, 2 * qw))
            * np.where(rng.random((a["dest"].shape[0], 2 * qh, 2 * qw))
                       < 0.5, 1, -1)).astype(np.int64)
           for (qw, qh, *_r), a in zip(shapes, bargs)]
    # sign-magnitude words: bit 31 the sign, the magnitude above the
    # 31 - magb shift
    mus = [np.where(m < 0, (1 << 31) | ((-m) << 16), m << 16)
           .astype(np.uint32).view(np.int32) for m in mus]
    pf_idx, pf_val = pf_idx.copy(), pf_val.copy()
    pf_idx[0] = bargs[0]["dest"][0]
    pf_val[0] = 12345
    return geom, shapes, bargs, pf_idx, pf_val, mus


def test_bucket_scatter_and_plan_equal_jax_compiled_assembly():
    """The same mu words through the port's ``bucket_scatter_ref``, its
    flat plan (``dwt_lift_program_ref``, small levels included) and pack,
    and through the JAX ``_compiled_assembly``: the same packed bytes. A
    prefill entry under a lane sample gives the lane's sample in both."""
    geom, shapes, bargs, pf_idx, pf_val, mus = _bucket_inputs()
    key = geom.key()
    prog = port_asm.BucketProgram(shapes, key)
    assert prog.lift.small_launches == 1
    tb = [{k: torch.from_numpy(np.asarray(v)) if isinstance(v, np.ndarray)
           else v for k, v in a.items()} for a in bargs]
    tmus = [torch.from_numpy(m) for m in mus]
    flat = coef_cuda.bucket_scatter_ref(
        tmus, prog.dims, tb, torch.from_numpy(pf_idx),
        torch.from_numpy(pf_val), prog.total, prog.transform, False)
    lane0 = coef_cuda.dequant(tmus[0][:1], tb[0]["magb"][:1],
                              tb[0]["istep"][:1], tb[0]["scale97"][:1],
                              tb[0]["fscale"][:1], prog.transform, False)
    assert int(flat[int(pf_idx[0])]) == int(lane0[0, 0, 0]) != 12345
    scratch = dwt_cuda.dwt_lift_program_ref(prog.lift, flat)
    outs = [flat[off:off + ph * pw].view(ph, pw) if last is None
            else prog.lift.view(scratch, last)
            for (off, ph, pw), last in zip(prog.planes, prog.lift.last)]
    got = prog.pack(outs, torch.ones(1, dtype=torch.bool)).numpy()

    fn = jax_decoder._compiled_assembly(tuple(map(tuple, shapes)), key)
    keys = ("fscale", "scale97", "magb", "istep", "dest", "stride")
    jargs = [{**{k: jnp.asarray(a[k]) for k in keys}, "nreal": a["nreal"]}
             for a in bargs]
    want = fn(jnp.asarray(pf_idx), jnp.asarray(pf_val),
              [jnp.asarray(m) for m in mus],
              [jnp.ones(m.shape[0], bool) for m in mus], jargs)
    assert np.array_equal(got.view(np.uint16),
                          np.asarray(want).astype(np.uint16))


@pytest.mark.parametrize("out_dtype,cbps", [(torch.uint8, 8),
                                            (torch.int16, 16),
                                            (torch.int16, 10)])
def test_plane_writeframe_plain_route(out_dtype, cbps):
    """``plane_writeframe_ref`` (what ``plane_writeframe`` takes on the
    CPU): float samples rounded half to even (the .5 ties), + 2^(cbps-1),
    clipped, narrowed (uint16 as int16 bits), each plane at its offset,
    the samples between planes untouched."""
    shift, top = 1 << (cbps - 1), (1 << cbps) - 1
    ties = np.arange(-8, 8) + 0.5
    f = np.concatenate([ties, [-1e6, 1e6, 0.49999997]]).astype(np.float32)
    i = np.array([-(1 << 31), -shift - 1, -shift, 0, top, 1 << 30],
                 np.int32)
    for src in (f, i):
        out = torch.full((len(src) + 5,), 7, dtype=out_dtype)
        planes = [torch.from_numpy(src[:4]), torch.from_numpy(src[4:])]
        got = mct_cuda.plane_writeframe(planes, cbps, out, [0, 9])
        v = np.rint(src).astype(np.int64) if src.dtype == np.float32 \
            else src.astype(np.int64)
        want = np.clip((v + shift + (1 << 31)) % (1 << 32) - (1 << 31), 0,
                       top)
        g = got.numpy().view(np.uint16 if out_dtype == torch.int16
                             else np.uint8).astype(np.int64)
        assert np.array_equal(g[:4], want[:4])
        assert np.array_equal(g[9:9 + len(src) - 4], want[4:])
        assert (g[4:9] == 7).all()


@pytest.mark.parametrize("name", ["gray10", "rgb97"])
def test_layered_stream_with_small_levels_on_the_v2_path(name):
    """A layered 96x128 stream whose lowest DWT level is 8x6 (a level
    under 8x8 on the v2 path) through ``Decoder(device="cpu")``: the
    BucketProgram, with a small job, gives the host oracle's bytes (and
    the source for the lossless gray stream)."""
    if name == "gray10":
        data, src = STREAM, GRAY10
    else:
        src = np.random.default_rng(11).integers(0, 256, (96, 128, 3),
                                                 dtype=np.uint8)
        data = encode_frame_htj2k(src, pred=0, mct=True, **LAYERED)
    dec = Decoder(device="cpu")
    got = dec.decode(data)
    assert (dec.v3_frames, dec.v2_frames, dec.host_frames) == (0, 1, 0)
    hdr = dec._parse(data)
    fg = dec._fast_geom(hdr)
    geom, (shapes, *_rest), _acc = dec._v2_args(
        fg, [port_fp.parse_frame_flat(hdr, fg)])
    prog = port_decoder.bucket_program(tuple(map(tuple, shapes)), geom.key())
    assert prog.lift.small_launches == 1
    assert got.tobytes() == port_host.decode_frame(data,
                                                   bitexact=True).tobytes()
    if name == "gray10":
        assert np.array_equal(got.planes[0].reshape(96, 128),
                              src.astype(np.uint16) << 6)


@pytest.mark.parametrize("tname", list(TRANSFORMS))
def test_v3_program_with_small_levels_equals_the_composed_route(tname):
    """A V3Program whose lowest DWT level is under 8x8 (96x128, six
    resolution levels) runs the band route (``coef_mosaic`` + the plan's
    small and band-direct jobs): its planes equal, by bits, the JAX
    program's flat fallback as the port had it, the dequant, the prefill,
    the quadrant pyramid composed (``_compose_plane``) and
    ``dwt_decode_flat``."""
    from ffmpeg_ht_tpu_torch.ops.ht_scan import decode_cleanup_scan_dims

    t = TRANSFORMS[tname]
    img = np.random.default_rng(13).integers(0, 256, (96, 128, 3),
                                             dtype=np.uint8)
    data = encode_frame_htj2k(img, pred=int(t == DWT53), mct=True,
                              nreslevels=6, log2_cblk_width=5,
                              log2_cblk_height=5)
    dec = Decoder(device="cpu", bitexact=t != DWT97)
    hdr = dec._parse(data)
    fg = dec._fast_geom(hdr)
    prog, args = dec._v3_program(fg, [port_fp.parse_frame_flat(hdr, fg)])
    assert not prog.band_direct and prog.lift.small_launches == 1
    outs, _ok = prog.decode_planes(**args)
    mu, _sig, _ok = decode_cleanup_scan_dims(
        *(args[k] for k in ("msw", "melw", "vlcw", "pLSB", "maxbp",
                            "ms_lim", "mel_lim", "qws", "qhs")),
        prog.qw, prog.qh, prog.ms_class)
    coef = coef_cuda.prefill(coef_cuda.dequant(
        mu, args["magb"], args["istep"], args["scale97"], args["fscale"],
        t, prog.no_istep), args["pf_idx"], args["pf_val"])
    for out, plane, border, ndec in zip(outs, prog.plan.planes,
                                        prog.borders, prog.ndecs):
        want = dwt_torch.dwt_decode_flat(
            port_asm._compose_plane(coef, plane, 0),
            [list(border[0]), list(border[1])], ndec, t)
        assert torch.equal(_bits(out), _bits(want))
