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

import copy

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
    prog = port_asm.BucketProgram(shapes, key,
                                  port_asm.FrameLayout.identity(key))
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
        got = mct_cuda.plane_writeframe(
            planes, cbps, out, [mct_cuda.back_to_back((1, p.numel()), 1, o)[0]
                                for p, o in zip(planes, (0, 9))])
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
    prog = port_decoder.bucket_program(tuple(map(tuple, shapes)), geom.key(),
                                       dec._layout([hdr], fg.geom))
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
    prog, args = dec._v3_program(fg, [port_fp.parse_frame_flat(hdr, fg)],
                                 dec._layout([hdr], fg.geom))
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


# ---------------------------------------------------------------------------
# csrc/bucket_scatter.cu's schedule, emulated: the lane pass's warp tasks
# (kUnroll row groups of one lane, 4 samples a thread, kWarps warps a block,
# MAX_BUCKETS buckets a launch), the coverage bitmap it writes, then the
# zeros where no lane wrote, then the prefill where no lane wrote
# ---------------------------------------------------------------------------

_UNROLL = 4                  # kUnroll: row groups a warp task
_GARBAGE = 0x5A5A5A5A        # what an unwritten sample of the buffer holds


def _ceil_log2(n):
    return (n - 1).bit_length() if n > 1 else 0


def _scatter_tasks(n, h, w):
    """A bucket's warp tasks as the kernel maps them: (lane, y, x) of every
    4-sample chunk a thread loads, and (lane, y, first word, thread's
    first word, word step) of every row whose coverage words it writes."""
    lg = min(_ceil_log2((w + 3) >> 2), 5)
    rpw = 32 >> lg
    tpl = -(-h // (rpw * _UNROLL)) if h else 0
    task, thread, m, u = np.meshgrid(np.arange(n * tpl), np.arange(32),
                                     np.arange(-(-((w + 3) >> 2) // 32) or 1),
                                     np.arange(_UNROLL), indexing="ij")
    lane = task // max(tpl, 1)
    c0 = thread & ((1 << lg) - 1)
    y = (task - lane * tpl) * rpw * _UNROLL + (thread >> lg) + u * rpw
    c = c0 + 32 * m
    return lane, y, 4 * c, c < (w + 3) >> 2, c0, 1 << lg, m == 0


def _emulate_scatter(mus, dims, lanes, pf_idx, pf_val, total, transform,
                     no_istep):
    """What bucket_scatter's three passes write, from numpy arrays: the
    flat buffer (int64 bit patterns; an unwritten sample keeps _GARBAGE).
    Raises if a sample is written twice by the lanes, or if the bitmap
    marks other samples than the lanes wrote."""
    out = np.full(total + 1, _GARBAGE, np.int64)
    bits = np.zeros((total + 32) // 32, np.int64)
    hits = np.zeros(total + 1, np.int64)
    for b0 in range(0, len(mus), coef_cuda.MAX_BUCKETS):   # a launch
        for mu, (w, h), a in list(zip(mus, dims, lanes))[
                b0:b0 + coef_cuda.MAX_BUCKETS]:
            n = mu.shape[0]
            if not n:
                continue
            coef = coef_cuda.dequant(*(torch.from_numpy(np.asarray(v)) for v
                                       in (mu, a["magb"], a["istep"],
                                           a["scale97"], a["fscale"])),
                                     transform, no_istep)
            coef = _bits(coef).numpy().astype(np.int64)
            lane, y, x, cok, c0, step, first = _scatter_tasks(n, h, w)
            dest = np.asarray(a["dest"]).astype(np.int64)[lane]
            stride = np.asarray(a["stride"]).astype(np.int64)[lane]
            row = (dest >= 0) & (y < h)
            for k in range(4):
                ok = row & cok & (x + k < w)
                at = dest + y * stride + x + k
                ok &= at < total
                at, v = at[ok], coef[lane[ok], y[ok], x[ok] + k]
                np.add.at(hits, at, 1)
                out[at] = v
            # the rows' coverage words, word j of a row by its thread j
            # (mod the row's threads)
            row &= first
            a0 = (dest + y * stride)[row]
            a1 = np.minimum(a0 + w, total)
            c0r, stepr = c0[row], np.broadcast_to(step, row.shape)[row]
            for j in range(0, (w + 31) // 32 + 2):
                wd = (a0 >> 5) + c0r + j * stepr
                s = wd << 5
                ok = (a0 < a1) & (c0r + j * stepr <= ((a1 - 1) >> 5)
                                  - (a0 >> 5))
                lo = np.clip(a0 - s, 0, 32)[ok]
                hi = np.clip(a1 - s, 0, 32)[ok]
                mask = ((1 << hi) - 1) & ~((1 << lo) - 1)
                np.bitwise_or.at(bits, wd[ok], mask)
    assert hits.max(initial=0) <= 1, "a sample written twice"
    covered = (bits[np.arange(total + 1) >> 5] >> (np.arange(total + 1)
                                                   & 31)) & 1
    assert np.array_equal(covered == 1, hits == 1), "bitmap != lane writes"
    out[covered == 0] = 0                                 # the zero pass
    idx = np.asarray(pf_idx).astype(np.int64)
    val = _bits(torch.from_numpy(np.asarray(pf_val))).numpy()
    live = (idx >= 0) & (idx < total)
    live[live] &= covered[idx[live]] == 0                 # the prefill
    out[idx[live]] = val[live]
    return out


@pytest.mark.parametrize("case", ["program", "uncovered"])
def test_scatter_schedule_equals_ref_and_jax_compiled_assembly(case):
    """bucket_scatter's schedule (emulated above) on STREAM's v2 program,
    with random mu words and a prefill entry under a lane sample; in the
    "uncovered" case every third lane is dropped (its codeblock then has
    no lane: zeros, and the prefill entries put into it) and prefill
    entries land in those codeblocks: equal by bits to
    bucket_scatter_ref, and through the plan and the pack to the JAX
    ``_compiled_assembly``, with every sample written."""
    geom, shapes, bargs, pf_idx, pf_val, mus = _bucket_inputs()
    if case == "uncovered":
        rng = np.random.default_rng(17)
        extra = []
        for a in bargs:
            dest = a["dest"].copy()
            drop = (np.arange(len(dest)) % 3 == 1) & (dest >= 0)
            extra += [d + 1 for d in dest[drop]]
            dest[drop] = -1
            a["dest"] = dest
        assert extra
        pf_idx = np.concatenate([pf_idx, np.array(extra, np.int32)])
        pf_val = np.concatenate([pf_val, rng.integers(
            -500, 500, len(extra)).astype(pf_val.dtype)])
    prog = port_asm.BucketProgram(
        shapes, geom.key(), port_asm.FrameLayout.identity(geom.key()))
    got = _emulate_scatter(mus, prog.dims, bargs, pf_idx, pf_val,
                           prog.total, prog.transform, False)
    assert (got != _GARBAGE).all()
    tb = [{k: torch.from_numpy(np.asarray(v)) if isinstance(v, np.ndarray)
           else v for k, v in a.items()} for a in bargs]
    flat = coef_cuda.bucket_scatter_ref(
        [torch.from_numpy(m) for m in mus], prog.dims, tb,
        torch.from_numpy(pf_idx), torch.from_numpy(pf_val), prog.total,
        prog.transform, False)
    assert np.array_equal(got, _bits(flat).numpy().astype(np.int64))
    scratch = dwt_cuda.dwt_lift_program_ref(prog.lift, flat)
    outs = [flat[off:off + ph * pw].view(ph, pw) if last is None
            else prog.lift.view(scratch, last)
            for (off, ph, pw), last in zip(prog.planes, prog.lift.last)]
    packed = prog.pack(outs, torch.ones(1, dtype=torch.bool)).numpy()
    fn = jax_decoder._compiled_assembly(tuple(map(tuple, shapes)),
                                        geom.key())
    keys = ("fscale", "scale97", "magb", "istep", "dest", "stride")
    jargs = [{**{k: jnp.asarray(a[k]) for k in keys}, "nreal": a["nreal"]}
             for a in bargs]
    want = fn(jnp.asarray(pf_idx), jnp.asarray(pf_val),
              [jnp.asarray(m) for m in mus],
              [jnp.ones(m.shape[0], bool) for m in mus], jargs)
    assert np.array_equal(packed.view(np.uint16),
                          np.asarray(want).astype(np.uint16))


def _random_buckets(rng, transform, nbuckets=None):
    """Random buckets at disjoint places of a flat buffer (pad lanes, a
    bucket of no lanes, codeblocks smaller than their rasters, rows of 1
    to 200 samples, destinations and strides with and without 16-byte
    alignment), and a prefill that meets lane samples and free ones;
    with `nbuckets`, that many small buckets (more than one launch)."""
    total = 30000
    used = np.zeros(total, bool)
    specs = [(8, 8, 8, 8, 30), (8, 4, 5, 3, 23), (64, 64, 64, 61, 2),
             (4, 4, 4, 4, 0), (32, 16, 31, 16, 7), (6, 6, 5, 6, 9),
             (2, 2, 1, 2, 7), (256, 4, 200, 3, 2)]
    if nbuckets:
        specs = [(4, 4, 3 + i % 2, 4 - i % 3, 3) for i in range(nbuckets)]
    mus, dims, lanes = [], [], []
    for bw, bh, w, h, n in specs:
        dest, stride = np.full(n, -1, np.int32), np.zeros(n, np.int32)
        for i in range(n):
            if i % 5 == 4:
                continue                          # a pad lane
            for _try in range(100):
                st = int(rng.integers(w, w + 40))
                st = (st + 3) & ~3 if rng.random() < 0.5 else st
                d = int(rng.integers(0, total - (h - 1) * st - w))
                d = d & ~3 if rng.random() < 0.5 else d
                idx = (d + np.arange(h)[:, None] * st
                       + np.arange(w)[None]).ravel()
                if not used[idx].any():
                    used[idx] = True
                    dest[i], stride[i] = d, st
                    break
        mus.append(rng.integers(-2 ** 31, 2 ** 31, (n, bh, bw),
                                dtype=np.int64).astype(np.int32))
        dims.append((w, h))
        lanes.append(dict(
            dest=dest, stride=stride,
            magb=rng.integers(0, 40, n).astype(np.int32),
            istep=np.where(rng.random(n) < 0.3, 32768,
                           rng.integers(0, 70000, n)).astype(np.int32),
            scale97=rng.integers(-70000, 70000, n).astype(np.int32),
            fscale=(rng.random(n) * 1e-6).astype(np.float32)))
    idx = np.unique(np.concatenate([rng.choice(total, 1500, replace=False),
                                    [total]])).astype(np.int32)
    val = rng.integers(-9999, 9999, len(idx)).astype(
        np.float32 if transform == DWT97 else np.int32)
    return mus, dims, lanes, idx, val, total, used


@pytest.mark.parametrize("nbuckets", [None, 2 * coef_cuda.MAX_BUCKETS + 5])
@pytest.mark.parametrize("tname", list(TRANSFORMS))
def test_scatter_schedule_on_random_buckets(tname, nbuckets):
    """bucket_scatter's schedule (emulated above) on random buckets in
    all three transforms, with and without the step, and on more buckets
    than one launch takes: every lane sample written once, the bitmap
    exactly the lanes' samples, the buffer equal by bits to
    bucket_scatter_ref (pad lanes, rows outside the codeblocks and the
    prefill's pad written nowhere; out[total] 0)."""
    t = TRANSFORMS[tname]
    mus, dims, lanes, idx, val, total, used = _random_buckets(
        np.random.default_rng(60 + len(tname) + (nbuckets or 0)), t,
        nbuckets)
    assert used[idx[idx < total]].any() and (~used[idx[idx < total]]).any()
    for no_istep in (False, True):
        got = _emulate_scatter(mus, dims, lanes, idx, val, total, t,
                               no_istep)
        want = coef_cuda.bucket_scatter_ref(
            [torch.from_numpy(m) for m in mus], dims,
            [{k: torch.from_numpy(v) for k, v in a.items()} for a in lanes],
            torch.from_numpy(idx), torch.from_numpy(val), total, t,
            no_istep)
        assert got[total] == 0
        assert np.array_equal(got, _bits(want).numpy().astype(np.int64))


# ---------------------------------------------------------------------------
# csrc/dwt_small.cu's schedule, emulated: a block a plane over the plan's
# padded rows, the staged levels' bands gathered into shared memory in one
# wave, each lifting step one parity of every line at once (neighbours
# mirrored at a line's two ends only), each staged level's output written
# once and into the next level's LL places; the other levels in place in
# the output
# ---------------------------------------------------------------------------


def _wrap32(v):
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _q16(coef, s):
    return _wrap32((coef * s + (1 << 15)) >> 16)


def _step(t, st, x, a, b):
    """One lifting step of csrc/dwt_common.cuh on tensors (int64 holding
    int32 values, or float32)."""
    if t == DWT97:
        c = (dwt_torch._F_DELTA, dwt_torch._F_GAMMA, dwt_torch._F_BETA,
             dwt_torch._F_ALPHA)[st]
        m = c * (a + b)
        return x - m if st < 2 else x + m
    if t == DWT53:
        return _wrap32(x - (_wrap32(a + b + 2) >> 2)) if st == 0 \
            else _wrap32(x + (_wrap32(a + b) >> 1))
    s = a + b
    if st == 3:
        return _wrap32(x + _wrap32(_wrap32(s) + _q16(38413, s)))
    d = _q16((29066, 57862, 3472)[st], s)
    return _wrap32(x - d if st < 2 else x + d)


def _single(t, x, odd):
    if t == DWT97:
        return x * (dwt_torch._F_K_HALF if odd else dwt_torch._F_X)
    if t == DWT53:
        return x >> 1 if odd else x
    return _wrap32((x * 80621 + (1 << 16)) >> 17) if odd \
        else _wrap32((x * 53274 + (1 << 15)) >> 16)


def _lift_level(P, t, w, h, mh, mv):
    """A level's row steps, then its column steps, on P (h x w) in place:
    each step every sample of one parity at once, as the kernel's threads
    (positions from shifts and masks) compute it."""
    steps = 2 if t == DWT53 else 4
    if w == 1:
        P[:, 0] = _single(t, P[:, 0], mh & 1)
    else:
        lg = _ceil_log2((w + 1) >> 1)
        for st in range(steps):
            i = torch.arange(h << lg)
            x, y = 2 * (i & ((1 << lg) - 1)) + ((st ^ mh) & 1), i >> lg
            y, x = y[x < w], x[x < w]
            a = P[y, torch.where(x == 0, 1, x - 1)]
            b = P[y, torch.where(x == w - 1, w - 2, x + 1)]
            P[y, x] = _step(t, st, P[y, x], a, b)
    if h == 1:
        P[0] = _single(t, P[0], mv & 1)
    else:
        lg = _ceil_log2(w)
        for st in range(steps):
            i = torch.arange(((h + 1) >> 1) << lg)
            x, y = i & ((1 << lg) - 1), 2 * (i >> lg) + ((st ^ mv) & 1)
            keep = (x < w) & (y < h)
            x, y = x[keep], y[keep]
            a = P[torch.where(y == 0, 1, y - 1), x]
            b = P[torch.where(y == h - 1, h - 2, y + 1), x]
            P[y, x] = _step(t, st, P[y, x], a, b)


def _gather(d, src_in, src_out, P, with_ll):
    """A level's bands into P (h x w) at their interleaved places."""
    w, h, mh, mv = d[7:11]
    nE, nO = (w + 1 - mh) >> 1, w - ((w + 1 - mh) >> 1)
    lg = _ceil_log2(w)
    i = torch.arange(h << lg)
    x, y = i & ((1 << lg) - 1), i >> lg
    y, x = y[x < w], x[x < w]
    p, q = y + mv, x + mh
    lr, lc = (p & 1) == 0, (q & 1) == 0
    r = (p >> 1) - torch.where(lr, mv, 0)
    c = (q >> 1) - torch.where(lc, mh, 0)
    lls, bs = d[12] or nE, d[13]
    ll = src_out if d[1] else src_in
    for sel, buf, off, st in ((lr & lc, ll, d[2], lls),
                              (lr & ~lc, src_in, d[3], bs or nO),
                              (~lr & lc, src_in, d[4], bs or nE),
                              (~lr & ~lc, src_in, d[5], bs or nO)):
        if buf is ll and not with_ll:
            continue
        P[y[sel], x[sel]] = buf[off + r[sel] * st + c[sel]]


def _emulate_small(plan, bands):
    """What dwt_small writes into a fresh scratch buffer for `plan` (its
    padded device table, read on the CPU) from the 1-D `bands`; samples
    it does not write keep _GARBAGE. int64 bit patterns for the integer
    transforms, float32 for the float 9/7."""
    t = plan.transform
    fl = t == DWT97
    src = bands.clone() if fl else bands.to(torch.int64)
    out = torch.full((plan.total,), float("nan") if fl else _GARBAGE,
                     dtype=torch.float32 if fl else torch.int64)
    rows = plan.small_table_on(torch.device("cpu")).tolist()
    m = plan.small_maxchain
    for b in range(len(plan.small_chains) - 1):
        chain = [r for r in rows[b * m:(b + 1) * m] if r[7] > 0]
        S = {}                      # the staged levels, by offset
        for k, d in enumerate(chain):
            if d[14] < 0:
                break
            S[d[14]] = torch.full((d[8], d[7]), float("nan") if fl
                                  else _GARBAGE, dtype=out.dtype)
            _gather(d, src, out, S[d[14]], k == 0)
        for k, d in enumerate(chain):
            w, h, o = d[7], d[8], d[6]
            if d[14] < 0:
                P = out[o:o + w * h].view(h, w)
                _gather(d, src, out, P, True)
                _lift_level(P, t, w, h, d[9], d[10])
                if d[11]:
                    P.copy_(_wrap32((P + 128) >> 8))
                continue
            P = S[d[14]]
            _lift_level(P, t, w, h, d[9], d[10])
            out[o:o + w * h] = (_wrap32((P + 128) >> 8) if d[11]
                                else P).reshape(-1)
            if k + 1 < len(chain) and chain[k + 1][14] >= 0:
                nx = chain[k + 1]            # its LL: rows mv', cols mh'
                S[nx[14]][nx[10]:nx[10] + 2 * h:2,
                          nx[9]:nx[9] + 2 * w:2] = P
    return out


def _small_plan(sizes, mh, mv, t):
    """A LiftPlan of one-level planes of (w, h) `sizes` at parities
    (mh, mv), bands back to back."""
    shapes, planes = [], []
    for w, h in sizes:
        nE, nEv = (w + 1 - mh) // 2, (h + 1 - mv) // 2
        b = len(shapes)
        shapes += [(nEv, nE), (nEv, w - nE), (h - nEv, nE),
                   (h - nEv, w - nE)]
        planes.append((b, [(b + 1, b + 2, b + 3)], [(mh, mv)]))
    offsets = np.cumsum([0] + [r * c for r, c in shapes])[:-1].tolist()
    return dwt_cuda.LiftPlan(offsets, shapes, planes, t)


def _small_outputs(plan, buf):
    return [buf[o:o + w * h] for o, w, h in
            plan.small_table[:, 6:9].tolist()]


@pytest.mark.parametrize("mh,mv", [(0, 0), (1, 0), (0, 1), (1, 1)])
@pytest.mark.parametrize("tname", list(TRANSFORMS))
def test_small_schedule_equals_small_level_ref(tname, mh, mv):
    """dwt_small's parity-parallel schedule (emulated above) on every
    level with w < 8 or h < 8 up to 9 on the other side, at origin
    parities (mh, mv), a plane of one level each with the integer 9/7's
    final shift: equal by bits to dwt_level_small_ref job by job
    (``dwt_lift_program_ref``), every output sample written."""
    t = TRANSFORMS[tname]
    sizes = [(a, b) for a in range(1, 8) for b in range(1, 10)]
    sizes += [(b, a) for a, b in sizes if b >= 8]
    plan = _small_plan(sizes, mh, mv, t)
    assert plan.small_shared == len(sizes) and plan.small_device == 0
    rng = np.random.default_rng(70 + 2 * mh + mv + len(tname))
    bands = torch.from_numpy(rng.integers(-4000, 4000, plan.band_total)) \
        .to(_dtype(t))
    got = _emulate_small(plan, bands)
    want = dwt_cuda.dwt_lift_program_ref(plan, bands)
    for g, w_ in zip(_small_outputs(plan, got), _small_outputs(plan, want)):
        if t == DWT97:
            assert torch.equal(_bits(g), _bits(w_))
        else:
            assert torch.equal(g, w_.to(torch.int64))


# flat planes ((h, w), border, levels) whose small levels chain: the 8K
# frame's bottom tiles (32x7 and 16x7), odd origins with two small levels,
# and chains whose later levels do not fit dwt_small's shared memory
SMALL_CHAINS = [((224, 1024), ((0, 1024), (4096, 4320)), 6),
                ((224, 512), ((7168, 7680), (4096, 4320)), 6),
                ((37, 45), ((3, 48), (1, 38)), 3),
                ((6, 70), ((1, 71), (0, 6)), 2),
                ((1, 5), ((5, 10), (9, 10)), 3),
                ((3000, 6), ((1, 7), (3, 3003)), 2),
                ((5, 9000), ((0, 9000), (1, 6)), 3)]


@pytest.mark.parametrize("tname", list(TRANSFORMS))
def test_small_schedule_chains_and_storage(tname):
    """dwt_small's schedule (emulated above) on planes whose small levels
    chain, some of them too large for shared memory: the plan stages a
    prefix of each plane's levels at consecutive offsets within
    SMALL_SHARED_BYTES, the rest in device memory, and the outputs equal
    the plain small jobs by bits."""
    t = TRANSFORMS[tname]
    planes, off = [], 0
    for (h, w), _b, _n in SMALL_CHAINS:
        planes.append((off, h, w))
        off += h * w
    plan = port_asm.flat_lift_plan(planes, [b for _s, b, _n in SMALL_CHAINS],
                                   [n for _s, _b, n in SMALL_CHAINS], t,
                                   off + 1)
    assert plan.small_shared and plan.small_device
    rows = plan.small_table.tolist()
    for lo, hi in zip(plan.small_chains[:-1], plan.small_chains[1:]):
        at, staged = 0, True
        for r in rows[lo:hi]:
            if r[14] < 0:
                staged = False
                continue
            assert staged and r[14] == at
            at += r[7] * r[8]
        assert 4 * at <= min(plan.small_smem, dwt_cuda.SMALL_SHARED_BYTES)
    alone = copy.copy(plan)
    alone.table = plan.table[:0]          # the small jobs only
    rng = np.random.default_rng(90 + len(tname))
    bands = torch.from_numpy(rng.integers(-4000, 4000, plan.band_total)) \
        .to(_dtype(t))
    got = _emulate_small(plan, bands)
    want = dwt_cuda.dwt_lift_program_ref(alone, bands)
    for g, w_ in zip(_small_outputs(plan, got), _small_outputs(plan, want)):
        if t == DWT97:
            assert torch.equal(_bits(g), _bits(w_))
        else:
            assert torch.equal(g, w_.to(torch.int64))
