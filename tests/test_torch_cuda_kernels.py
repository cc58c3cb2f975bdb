"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``cuda``: needs an NVIDIA card and nvcc (the kernels are built from
ffmpeg_ht_tpu_torch/csrc at first use) and skips without them. Run on a
card with

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Integer kernels: the match is exact (the VLC pass's records on every
lane; the MagSgn pass's mu / sig / ok on every lane from the same
records; the pair's mu / sig on every ok lane and ok on every lane; RCT
samples bit for bit). The lanes are ragged (odd quad widths, every shape
up to the raster), with inert lanes and lanes whose U bound fails. The
ICT kernel matches its plain version exactly in both modes: the integer
mode on inputs whose Q16 products wrap, the float mode (no FMA
contraction, rint half to even) on random planes and on exact .5 ties.
The refinement kernels (``ht_sigprop_pass``, then ``ht_magref_pass``)
match ``refine_ref`` bit for bit, and each matches its plain half alone,
on random lanes (any sample words, quad patterns, refinement words, pLSB,
flags; a ragged last warp; flags alternating lane by lane; every raster
from 8x8 to 64x64; lanes where every sigma-0 sample becomes significant,
so that each block's 32-bit window fills) and on encoded codeblocks, where
both also equal the scalar oracle. The wire pack kernel matches
``pack_words_ref`` word for word at every depth 9..15 on ragged sample
counts, on all-ones and all-zeros samples, from an unaligned start, and
writes the ok flag word after the words; at the edges of its 8192-sample
tile (one short, one tile, one more, several tiles and a ragged tail),
at n = 0 (the flag word alone), on a grid of more tiles than the card
holds at once, and from every start offset of 1-7 samples (the scalar
path). ``coef_mosaic`` (dequant + prefill + band mosaic of a V3Program's
lanes) matches ``coef_mosaic_ref`` bit for bit in all three transforms on
a c3 plan and on plans whose codeblocks precincts cut and crop, from
random mu words, lane vectors (shifts past 31, wrapping steps) and
prefill entries with pads; ``dwt_lift`` matches ``dwt_level_ref`` bit
for bit in all three transforms on odd origins, the 8x8 minimum, c3's
and c2's top levels, more jobs than one launch takes, tall levels, lines
of 60000 samples, and an edge set (every size 8-67 and the tile seams
+-1 on both axes, at every origin-parity pair); ``dwt_lift_program``
(every level of a V3Program in one call) matches it level by level and
launches what ``kernel_launches()`` says; ``dwt_lift`` takes strided jobs
(bands that are corners of larger planes); the ``dwt_small`` kernel
(one ``dwt_lift_program`` call over planes of one small level) matches
``dwt_level_small_ref`` bit for bit on every level with a side of 1-7
against 1-67 (staged in shared memory) and on 70000-sample lines (in
device memory), at every parity; a flat buffer's quadrant pyramids
through one ``dwt_lift_program`` call (small and strided jobs, chains of
small levels that leave shared memory part way) match
``dwt_lift_program_ref``; ``bucket_scatter`` matches
``bucket_scatter_ref`` (pad lanes, cropped codeblocks, prefill entries
under lane samples, a buffer most of which no lane covers, 16-byte
aligned and odd destinations and strides, more buckets than two
launches take) and ``plane_writeframe`` matches
``plane_writeframe_ref`` (float ties, both output widths, more planes
than a launch takes); the three write kernels into a frame layout
(interleaved, shifted, offset; planar; scattered) match their plain
versions; a band-direct V3Program, one with levels under
8x8 and a BucketProgram on the card give the CPU decoder's bytes with
every plain stage made to raise. With two cards or more:
every kernel on the second card's tensors
while the first is current (the wrappers' launch guard), and
``decode_batch(devices=<every card>)`` against one card.
"""

import numpy as np
import pytest
import torch

from ffmpeg_ht_tpu_torch.ops import (coef_cuda, dwt_cuda, dwt_torch, ht_refine,
                                     ht_scan, mct_cuda, wirepack)
from ffmpeg_ht_tpu_torch.ops.dwt import DWT53, DWT97, DWT97_INT, dwt_levels
from ffmpeg_ht_tpu_torch.ops.ht_batch import (prepare_magref_stream,
                                              prepare_sigprop_stream,
                                              prepare_streams_batch,
                                              stream_limits)
from ffmpeg_ht_tpu_torch.ops.ht_dec import decode_htj2k
from ffmpeg_ht_tpu_torch.ops.ht_enc import encode_block_3pass, encode_cleanup

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _lanes(seed, n, qw, qh):
    """n random codeblocks (mixed shapes, depths, inert lanes) as lane
    arrays: (dict of int32 numpy arrays, ms_class)."""
    rng = np.random.default_rng(seed)
    rows, lcups, pcups, qws, qhs, zbps = [], [], [], [], [], []
    for i in range(n):
        if i % 7 == 3:                            # inert lane
            rows.append(b"")
            lcups.append(2)
            pcups.append(0)
            qws.append(0)
            qhs.append(0)
            zbps.append(0)
            continue
        w = int(rng.integers(1, 2 * qw + 1))
        h = int(rng.integers(1, 2 * qh + 1))
        zbp = int(rng.choice([3, 6, 10, 14, 20]))
        mag = rng.integers(0, 1 << zbp, (h, w)).astype(np.int64)
        mag = np.where(rng.random((h, w)) < rng.random(), 0, mag)
        sign = np.where(mag > 0, rng.integers(0, 2, (h, w)), 0)
        data, lcup = encode_cleanup(mag, sign.astype(np.int64), zbp)
        buf = bytearray(data[:lcup])
        scup = (data[lcup - 1] << 4) + (data[lcup - 2] & 0x0F)
        buf[lcup - 1] = 0xFF
        buf[lcup - 2] |= 0x0F
        rows.append(bytes(buf))
        lcups.append(lcup)
        pcups.append(lcup - scup)
        qws.append(-(-w // 2))
        qhs.append(-(-h // 2))
        zbps.append(zbp)
    cdat = np.zeros((n, max(max(len(r) for r in rows), 4)), np.uint8)
    for i, r in enumerate(rows):
        cdat[i, :len(r)] = np.frombuffer(r, np.uint8)
    lc, pc = np.asarray(lcups, np.int64), np.asarray(pcups, np.int64)
    msw, melw, vlcw = prepare_streams_batch(cdat, lc, pc)
    ms_lim, mel_lim = stream_limits(cdat, lc, pc)
    zb = np.asarray(zbps, np.int32)
    maxbp = zb + 1
    maxbp[[1, 2, 5]] = 1                         # U-bound violations
    arrays = dict(msw=msw, melw=melw, vlcw=vlcw, pLSB=30 - zb, maxbp=maxbp,
                  ms_lim=ms_lim, mel_lim=mel_lim,
                  qws=np.asarray(qws, np.int32), qhs=np.asarray(qhs, np.int32))
    keys = ("msw", "melw", "vlcw", "pLSB", "maxbp", "ms_lim", "mel_lim",
            "qws", "qhs")
    out = [np.ascontiguousarray(arrays[k]) for k in keys]
    out = [a.view(np.int32) if a.dtype == np.uint32 else a.astype(np.int32)
           for a in out]
    return out, min(int(zb.max()) + 1, 25)


def _launches():
    return ht_scan.ht_vlc_pass.launches, ht_scan.ht_magsgn_pass.launches


@pytest.mark.parametrize("qw,qh,n,seed", [(32, 32, 200, 1), (8, 8, 333, 2),
                                          (16, 4, 129, 3)])
def test_cleanup_kernel_matches_ref(cuda, qw, qh, n, seed):
    arrays, msc = _lanes(seed, n, qw, qh)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    before = _launches()
    mu, sig, ok = ht_scan.decode_cleanup_scan_dims(*args, qw, qh, msc)
    torch.cuda.synchronize()
    assert _launches() == (before[0] + 1, before[1] + 1)
    mu_r, sig_r, ok_r = ht_scan.cleanup_ref(*args, qw, qh, msc)
    assert torch.equal(ok, ok_r)
    assert not bool(ok_r.all()) and int(ok_r.sum()) > n // 2
    assert torch.equal(mu[ok_r], mu_r[ok_r])
    assert torch.equal(sig[ok_r], sig_r[ok_r])


@pytest.mark.parametrize("qw,qh,n,seed", [(32, 32, 300, 11), (16, 16, 257, 12),
                                          (16, 32, 97, 13)])
def test_vlc_pass_kernel_matches_ref(cuda, qw, qh, n, seed):
    arrays, _msc = _lanes(seed, n, qw, qh)
    msw, melw, vlcw, pLSB, maxbp, ms_lim, mel_lim, qws, qhs = \
        [torch.from_numpy(a).to(cuda) for a in arrays]
    assert (qws.remainder(2) == 1).any() and (qws == 0).any()
    before = ht_scan.ht_vlc_pass.launches
    rec = ht_scan.ht_vlc_pass(melw, vlcw, mel_lim, qws, qhs, qw, qh)
    torch.cuda.synchronize()
    assert ht_scan.ht_vlc_pass.launches == before + 1
    want = ht_scan.vlc_pass_ref(melw, vlcw, mel_lim, qws, qhs, qw, qh)
    assert rec.dtype == torch.int32 and torch.equal(rec, want)


@pytest.mark.parametrize("random_records", [False, True])
@pytest.mark.parametrize("qw,qh,n,seed", [(32, 32, 300, 21), (16, 16, 257, 22),
                                          (32, 8, 97, 23)])
def test_magsgn_pass_kernel_matches_ref(cuda, qw, qh, n, seed,
                                        random_records):
    """From the same records, mu / sig / ok agree on every lane, the lanes
    whose U bound fails included; random records exercise every field."""
    arrays, msc = _lanes(seed, n, qw, qh)
    msw, melw, vlcw, pLSB, maxbp, ms_lim, mel_lim, qws, qhs = \
        [torch.from_numpy(a).to(cuda) for a in arrays]
    rec = ht_scan.vlc_pass_ref(melw, vlcw, mel_lim, qws, qhs, qw, qh)
    if random_records:
        rng = np.random.default_rng(seed)
        f = lambda hi: rng.integers(0, hi, (n, qh, qw))
        rec = torch.from_numpy((f(16) | f(16) << 4 | f(16) << 8 | f(8) << 12)
                               .astype(np.int32)).to(cuda)
    before = ht_scan.ht_magsgn_pass.launches
    mu, sig, ok = ht_scan.ht_magsgn_pass(rec, msw, pLSB, maxbp, ms_lim, qws,
                                         qhs, qw, qh, msc)
    torch.cuda.synchronize()
    assert ht_scan.ht_magsgn_pass.launches == before + 1
    mu_r, sig_r, ok_r = ht_scan.magsgn_pass_ref(rec, msw, pLSB, maxbp, ms_lim,
                                                qws, qhs, qw, qh, msc)
    assert not bool(ok_r.all())
    assert torch.equal(ok, ok_r)
    assert torch.equal(mu, mu_r) and torch.equal(sig, sig_r)


def test_cleanup_kernel_rejects_bad_args(cuda):
    arrays, msc = _lanes(4, 20, 8, 8)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    with pytest.raises(TypeError):
        ht_scan.decode_cleanup_scan_dims(args[0].to(torch.int64), *args[1:],
                                         8, 8, msc)
    with pytest.raises(ValueError):
        ht_scan.decode_cleanup_scan_dims(*args, 33, 8, msc)
    with pytest.raises(ValueError):
        ht_scan.decode_cleanup_scan_dims(args[0], args[1], args[2],
                                         args[3][:-1], *args[4:], 8, 8, msc)


@pytest.mark.parametrize("cbps", [8, 10, 12, 16])
@pytest.mark.parametrize("shape", [(2160, 4096), (37, 53)])
def test_rct_kernel_matches_ref(cuda, cbps, shape):
    g = torch.Generator().manual_seed(cbps)
    lim = 1 << cbps
    y = [torch.randint(-lim, lim, shape, generator=g, dtype=torch.int32)
         .to(cuda) for _ in range(3)]
    ref = mct_cuda.rct_writeframe_ref(*y, cbps)
    before = mct_cuda.rct_writeframe.launches
    got = mct_cuda.rct_writeframe(*y, cbps)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    dtype = torch.uint8 if cbps <= 8 else torch.int16
    out = torch.empty(3 * y[0].numel(), dtype=dtype, device=cuda)
    mct_cuda.rct_writeframe(*y, cbps, out=out)
    assert mct_cuda.rct_writeframe.launches == before + 2
    want = torch.cat([mct_cuda.narrow(c, dtype).reshape(-1) for c in ref])
    assert torch.equal(out, want)


def _ict_inputs(transform, shape, cbps, seed, cuda):
    """Three planes on the card: int32 with a share reaching +-2^31 (every
    Q16 product and 2*y1 wraps), or float32 around the sample range."""
    g = torch.Generator().manual_seed(seed)
    lim = 1 << (cbps + 1)
    if transform == DWT97_INT:
        y = [torch.randint(-lim, lim, shape, generator=g, dtype=torch.int32)
             for _ in range(3)]
        for t in y:
            t[-2:] = torch.randint(-2 ** 31, 2 ** 31 - 1, t[-2:].shape,
                                   generator=g, dtype=torch.int32)
    else:
        y = [(torch.rand(shape, generator=g) - 0.5) * 2 * lim
             for _ in range(3)]
    return [t.to(cuda) for t in y]


@pytest.mark.parametrize("out_dtype", [torch.int32, torch.int16,
                                       torch.uint8])
@pytest.mark.parametrize("transform", [DWT97_INT, DWT97])
@pytest.mark.parametrize("shape", [(1080, 1920), (37, 53)])
def test_ict_kernel_matches_ref(cuda, transform, out_dtype, shape):
    """Three frames in one launch, each frame's samples frame_stride apart
    in the packed output; the single-frame form too."""
    cbps = {torch.int32: 12, torch.int16: 10, torch.uint8: 8}[out_dtype]
    frames = [_ict_inputs(transform, shape, cbps, cbps + transform + 7 * f,
                          cuda) for f in range(3)]
    ref = [mct_cuda.ict_writeframe_ref(*y, cbps, transform) for y in frames]
    before = mct_cuda.ict_writeframe.launches
    got = mct_cuda.ict_writeframe(frames[:1], cbps, transform)
    assert all(torch.equal(a, b) for a, b in zip(got[0], ref[0]))
    n = frames[0][0].numel()
    stride = 3 * n + 64
    out = torch.zeros(2 * stride + 3 * n, dtype=out_dtype, device=cuda)
    mct_cuda.ict_writeframe(frames, cbps, transform, out=out,
                            frame_stride=stride)
    torch.cuda.synchronize()
    assert mct_cuda.ict_writeframe.launches == before + 2
    for f in range(3):
        want = torch.cat([mct_cuda.narrow(c, out_dtype).reshape(-1)
                          for c in ref[f]])
        assert torch.equal(out[f * stride:f * stride + 3 * n], want)
    assert not out[3 * n:stride].any()               # the gaps untouched


def test_ict_kernel_float_rounding_ties(cuda):
    """Exact .5 results round half to even; then random planes whose y0
    sits on a .5, so that many results land near a rounding boundary,
    where an FMA in place of a multiply and an add would move some."""
    ties = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 100.5])
    zero = torch.zeros_like(ties)
    y = [t.reshape(1, -1).to(cuda) for t in (ties, zero, zero)]
    (got,) = mct_cuda.ict_writeframe([y], 12, DWT97)
    want = [v + 2048 for v in (0, 2, 2, 0, -2, -2, 4, 100)]
    assert [g.reshape(-1).tolist() for g in got] == [want] * 3
    g = torch.Generator().manual_seed(9)
    y = [((torch.rand((512, 512), generator=g) - 0.5) * 4096).to(cuda)
         for _ in range(3)]
    y[0] = torch.floor(y[0]) + 0.5
    ref = mct_cuda.ict_writeframe_ref(*y, 12, DWT97)
    (got,) = mct_cuda.ict_writeframe([y], 12, DWT97)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_ict_kernel_many_frames(cuda):
    """More frames than one launch takes (32): two launches, all right."""
    frames = [_ict_inputs(DWT97_INT, (16, 24), 8, f, cuda) for f in range(40)]
    before = mct_cuda.ict_writeframe.launches
    got = mct_cuda.ict_writeframe(frames, 8, DWT97_INT)
    torch.cuda.synchronize()
    assert mct_cuda.ict_writeframe.launches == before + 2
    for y, g in zip(frames, got):
        ref = mct_cuda.ict_writeframe_ref(*y, 8, DWT97_INT)
        assert all(torch.equal(a, b) for a, b in zip(g, ref))


def test_ict_kernel_rejects_bad_args(cuda):
    y = _ict_inputs(DWT97, (8, 8), 8, 1, cuda)
    out = torch.empty(3 * 64, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):              # 10 bits into uint8
        mct_cuda.ict_writeframe([y], 10, DWT97, out=out)
    with pytest.raises(ValueError):
        mct_cuda.ict_writeframe([y], 0, DWT97)
    with pytest.raises(TypeError):               # int planes, float mode
        mct_cuda.ict_writeframe([[t.to(torch.int32) for t in y]], 8, DWT97)
    with pytest.raises(ValueError):
        mct_cuda.ict_writeframe([y], 8, DWT97, out=out[1:])
    with pytest.raises(ValueError):              # planes on two shapes
        mct_cuda.ict_writeframe([y, [t[:4] for t in y]], 8, DWT97)


def _frame_dests(layout, shape, cbps, out_dtype):
    """(dests of three (H, W) planes in a frame, the output's size):
    "inter", R, G, B interleaved as a tile at x 5, y 2 of a frame whose
    rows are 3 * (W + 9) samples, shifted to the top of the sample type;
    "inter-flat", interleaved rows back to back from an unaligned start;
    "planar", three planes with padded rows at odd offsets; "scatter",
    every fourth sample (an alpha slot between, left alone)."""
    h, w = shape
    sh = {torch.uint8: 8, torch.int16: 16, torch.int32: 30}[out_dtype] - cbps
    if layout == "inter":
        rs = 3 * (w + 9)
        base = 2 * rs + 15
        return [(base + k, rs, 3, sh) for k in range(3)], base + h * rs
    if layout == "inter-flat":
        return [(3 + k, 3 * w, 3, sh) for k in range(3)], 3 * h * w + 3
    if layout == "planar":
        rs = w + 3
        return ([(1 + k * (h * rs + 5), rs, 1, sh) for k in range(3)],
                3 * (h * rs + 5))
    rs = 4 * w + 4
    return [(k + 2, rs, 4, sh) for k in range(3)], h * rs


@pytest.mark.parametrize("layout", ["inter", "inter-flat", "planar",
                                    "scatter"])
@pytest.mark.parametrize("shape", [(2160, 4096), (37, 1053)])
@pytest.mark.parametrize("out_dtype,cbps", [(torch.uint8, 8),
                                            (torch.int16, 10),
                                            (torch.int32, 12)])
def test_write_kernels_in_a_frame_layout_match_their_plain_versions(
        cuda, layout, shape, out_dtype, cbps):
    """rct_writeframe, ict_writeframe (both modes, three frames a launch)
    and plane_writeframe writing into an interleaved, shifted, offset
    frame layout (and a planar and a scattered one) against their plain
    versions; the samples no dest takes keep their value."""
    dests, size = _frame_dests(layout, shape, cbps, out_dtype)
    g = torch.Generator().manual_seed(cbps + len(layout))
    lim = 1 << (cbps + 1)
    y = [torch.randint(-lim, lim, shape, generator=g, dtype=torch.int32)
         .to(cuda) for _ in range(3)]
    want = torch.full((size,), 77, dtype=out_dtype, device=cuda)
    got = want.clone()
    mct_cuda.rct_writeframe_ref(*y, cbps, want, dests)
    mct_cuda.rct_writeframe(*y, cbps, out=got, dests=dests)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    stride = size + 37
    for transform in (DWT97_INT, DWT97):
        frames = [_ict_inputs(transform, shape, cbps, cbps + 7 * f, cuda)
                  for f in range(3)]
        want = torch.full((2 * stride + size,), 77, dtype=out_dtype,
                          device=cuda)
        got = want.clone()
        for f, fy in enumerate(frames):
            mct_cuda.ict_writeframe_ref(
                *fy, cbps, transform, want,
                [(d + f * stride, rs, cs, sh) for d, rs, cs, sh in dests])
        mct_cuda.ict_writeframe(frames, cbps, transform, out=got,
                                frame_stride=stride, dests=dests)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    want = torch.full((size,), 77, dtype=out_dtype, device=cuda)
    got = want.clone()
    mct_cuda.plane_writeframe_ref(y, cbps, want, dests)
    mct_cuda.plane_writeframe(y, cbps, got, dests)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


_REFINE_KEYS = ("mu", "sig", "spw", "mrw", "pLSB", "has_sp", "has_mr",
                "causal")


def _refine_launches():
    return (ht_refine.ht_sigprop_pass.launches,
            ht_refine.ht_magref_pass.launches,
            ht_refine.decode_refinement_scan.launches)


def _refine_both(lanes, qw, qh, w, h, cuda):
    """(kernel output, refine_ref output) as uint32 numpy arrays, after
    holding each kernel alone against its plain half: ``ht_sigprop_pass``
    (its words) and ``ht_magref_pass`` given the plain words."""
    t = dict(zip(_REFINE_KEYS, (
        torch.from_numpy(np.ascontiguousarray(lanes[k]).view(np.int32)
                         if lanes[k].dtype == np.uint32 else lanes[k])
        for k in _REFINE_KEYS)))
    c = {k: v.to(cuda) for k, v in t.items()}
    s_in = ("sig", "spw", "has_sp", "causal")
    m_in = ("mu", "sig", "mrw", "pLSB", "has_mr")
    before = _refine_launches()
    words = ht_refine.ht_sigprop_pass(*[c[k] for k in s_in], qw, qh, w, h)
    words_r = ht_refine.sigprop_pass_ref(*[t[k] for k in s_in], qw, qh, w,
                                         h)
    assert torch.equal(words.cpu(), words_r)
    got_m = ht_refine.ht_magref_pass(*[c[k] for k in m_in],
                                     words_r.to(cuda), qw, qh, w, h)
    want = ht_refine.magref_pass_ref(*[t[k] for k in m_in], words_r, qw, qh,
                                     w, h)
    assert torch.equal(got_m.cpu(), want)
    got = ht_refine.decode_refinement_scan(*c.values(), qw, qh, w, h)
    torch.cuda.synchronize()
    assert _refine_launches() == (before[0] + 2, before[1] + 2,
                                  before[2] + 1)
    assert torch.equal(ht_refine.refine_ref(*t.values(), qw, qh, w, h),
                       want)
    return got.cpu().numpy().view(np.uint32), want.numpy().view(np.uint32)


def _random_refine_lanes(rng, n, qw, qh, sp_words=40):
    """n random lanes: any words, patterns, pLSB and has_sp / has_mr /
    causal mix."""
    u32 = lambda *shape: rng.integers(0, 2 ** 32, shape, dtype=np.uint64) \
        .astype(np.uint32)
    return dict(
        mu=u32(n, 2 * qh, 2 * qw),
        sig=(rng.integers(0, 16, (n, qh, qw))
             * (rng.random((n, qh, qw)) < rng.random())).astype(np.int32),
        spw=u32(n, sp_words), mrw=u32(n, 24),
        pLSB=rng.integers(2, 31, n).astype(np.int32),
        has_sp=rng.random(n) < 0.8, has_mr=rng.random(n) < 0.6,
        causal=rng.random(n) < 0.5)


@pytest.mark.parametrize("qw,qh,n,seed", [(32, 32, 67, 31), (16, 16, 130, 32),
                                          (9, 15, 41, 33), (10, 10, 9, 34),
                                          (1, 32, 5, 35), (32, 3, 7, 36)])
def test_refine_kernel_matches_ref_random(cuda, qw, qh, n, seed):
    """Random lanes: any words, patterns, pLSB and has_sp / has_mr / causal
    mix; codeblock one sample narrower and shorter than the raster."""
    lanes = _random_refine_lanes(np.random.default_rng(seed), n, qw, qh)
    w, h = max(2 * qw - 1, 1), max(2 * qh - 1, 1)
    got, want = _refine_both(lanes, qw, qh, w, h, cuda)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("case,q,n", [
    ("random", 16, 1), ("random", 16, 33), ("random", 16, 1000),
    ("random", 4, 70), ("random", 8, 70), ("random", 32, 70),
    ("dense", 8, 37), ("dense", 16, 37), ("dense", 32, 37),
    ("alternating", 16, 64), ("alternating", 32, 45)])
def test_refine_kernels_cases(cuda, case, q, n):
    """A q x q quad raster (8x8 .. 64x64) holding a codeblock one sample
    narrower and shorter. N of 1, 33 and 1000 leave the last warp of the
    SigProp kernel ragged. "dense": the raster's first row significant and
    all-ones SigProp words on even lanes, so every other sigma-0 sample
    becomes significant, each 4x4 block reads 32 bits and the windows
    cross word boundaries. "alternating": has_sp, has_mr and causal change
    lane by lane."""
    rng = np.random.default_rng(q * 1000 + n)
    w = h = 2 * q - 1
    lanes = _random_refine_lanes(rng, n, q, q, 2 * q * q // 8 + 2)
    i = np.arange(n)
    if case == "dense":
        lanes["sig"][:] = 0
        lanes["sig"][:, 0] = 5               # corners (0, 0) and (0, 1)
        lanes["spw"][::2] = 0xFFFFFFFF
        lanes["has_sp"][:] = True
    elif case == "alternating":
        lanes.update(has_sp=i % 2 == 0, has_mr=i % 3 != 1,
                     causal=(i // 2) % 2 == 1)
    got, want = _refine_both(lanes, q, q, w, h, cuda)
    assert np.array_equal(got, want)
    if case == "dense":
        pL = lanes["pLSB"][::2, None, None].astype(np.uint32) - 1
        assert ((want[::2, 1:h, :w] >> pL) & 1).all()


def _encoded_refine_lanes(rng, w, h, n, causal):
    """n codeblocks from encode_block_3pass (z_blk 3, 2, 1 in turn; all 3
    when causal), cleanup by cleanup_ref: (lanes, oracle samples)."""
    zbp, magb = 6, 8
    blocks = []
    while len(blocks) < n:
        mag = rng.integers(0, 128, (h, w)).astype(np.int64)
        mag = np.where(rng.random((h, w)) < rng.random(), 0, mag)
        sign = np.where(mag > 0, rng.integers(0, 2, (h, w)), 0)
        enc = encode_block_3pass(mag, sign.astype(np.int64), zbp,
                                 is_causal=int(causal))
        if enc is not None:
            blocks.append((*enc, 3 if causal else (3, 2, 1)[len(blocks) % 3]))
    qw, qh = -(-w // 2), -(-h // 2)
    cdat = np.zeros((n, max(len(b[0]) for b in blocks)), np.uint8)
    dref = np.zeros((n, max(max(b[2] for b in blocks), 4)), np.uint8)
    lcups, pcups, lrefs = (np.zeros(n, np.int64) for _ in range(3))
    for i, (data, lcup, lref, npass) in enumerate(blocks):
        buf = bytearray(data[:lcup])
        scup = (buf[lcup - 1] << 4) + (buf[lcup - 2] & 0x0F)
        buf[lcup - 1] = 0xFF
        buf[lcup - 2] |= 0x0F
        cdat[i, :lcup] = np.frombuffer(bytes(buf), np.uint8)
        lcups[i], pcups[i] = lcup, lcup - scup
        if npass > 1:
            dref[i, :lref] = np.frombuffer(data[lcup:lcup + lref], np.uint8)
            lrefs[i] = lref
    msw, melw, vlcw = prepare_streams_batch(cdat, lcups, pcups)
    ms_lim, mel_lim = stream_limits(cdat, lcups, pcups)
    t = lambda a: torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                   else a.astype(np.int32))
    full = torch.ones(n, dtype=torch.int32)
    mu, sig, ok = ht_scan.cleanup_ref(
        t(msw), t(melw), t(vlcw), full * (30 - zbp), full * (zbp + 1),
        t(ms_lim), t(mel_lim), full * qw, full * qh, qw, qh, zbp + 1)
    assert bool(ok.all())
    npasses = np.array([b[3] for b in blocks])
    lanes = dict(mu=mu.numpy().view(np.uint32), sig=sig.numpy(),
                 spw=prepare_sigprop_stream(dref, lrefs),
                 mrw=prepare_magref_stream(dref, lrefs),
                 pLSB=np.full(n, 30 - zbp, np.int32), has_sp=npasses >= 2,
                 has_mr=npasses >= 3, causal=np.full(n, causal))
    want = [decode_htj2k(d, npass, zbp, [lcup, lref], w, h, magb, 0,
                         int(causal)).view(np.uint32)
            for d, lcup, lref, npass in blocks]
    return lanes, want


@pytest.mark.parametrize("w,h,causal", [(32, 32, False), (17, 29, False),
                                        (64, 64, False), (32, 32, True),
                                        (20, 19, True), (64, 64, True)])
def test_refine_kernel_matches_ref_encoded(cuda, w, h, causal):
    lanes, oracle = _encoded_refine_lanes(np.random.default_rng(w + h),
                                          w, h, 9, causal)
    got, want = _refine_both(lanes, -(-w // 2), -(-h // 2), w, h, cuda)
    assert np.array_equal(got, want)
    for i, o in enumerate(oracle):
        assert np.array_equal(got[i, :h, :w], o), f"lane {i}"


def test_refine_kernel_rejects_bad_args(cuda):
    n, qw, qh = 4, 8, 8
    z = lambda *s: torch.zeros(s, dtype=torch.int32, device=cuda)
    b = torch.zeros(n, dtype=torch.bool, device=cuda)
    args = [z(n, 16, 16), z(n, 8, 8), z(n, 4), z(n, 4), z(n) + 10, b, b, b]
    with pytest.raises(ValueError):                  # w beyond the raster
        ht_refine.decode_refinement_scan(*args, qw, qh, 17, 16)
    with pytest.raises(ValueError):                  # 66-sample raster
        ht_refine.decode_refinement_scan(*args, 33, qh, 16, 16)
    with pytest.raises(TypeError):
        ht_refine.decode_refinement_scan(*args[:5], b.to(torch.int32),
                                         *args[6:], qw, qh, 16, 16)
    with pytest.raises(ValueError):                  # sig of another shape
        ht_refine.decode_refinement_scan(args[0], z(n, 8, 7), *args[2:],
                                         qw, qh, 16, 16)
    words = ht_refine.ht_sigprop_pass(args[1], args[2], b, b, qw, qh, 16, 16)
    with pytest.raises(ValueError):                  # words of another shape
        ht_refine.ht_magref_pass(args[0], args[1], args[3], args[4], b,
                                 words[:, :, :1], qw, qh, 16, 16)


WIRE_TILE = 256 * 32        # samples a block of the kernel packs (16 KB)


@pytest.mark.parametrize("depth", range(9, 16))
@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000, 100003,
                               # the flag word alone; a tile's edges; a
                               # ragged tail, and a tile of whole groups
                               0, WIRE_TILE - 1, WIRE_TILE, WIRE_TILE + 1,
                               5 * WIRE_TILE + 77, 7 * WIRE_TILE + 8160])
def test_wire_pack_kernel_matches_ref(cuda, depth, n):
    rng = np.random.default_rng(depth * 7 + n)
    src = rng.integers(0, 1 << depth, n + 1, dtype=np.uint16)
    src[-1] = n % 2                                      # the ok flag
    flat = torch.from_numpy(src.view(np.int16)).to(cuda)
    before = wirepack.pack_words.launches
    got = wirepack.pack_words(flat, depth)
    torch.cuda.synchronize()
    assert wirepack.pack_words.launches == before + 1
    want = wirepack.pack_words_ref(flat[:n].cpu(), depth)
    assert got.shape == (wirepack.packed_words_len(n, depth) + 1,)
    assert torch.equal(got[:-1].cpu(), want) and int(got[-1]) == n % 2
    back = wirepack.unpack_words(want.numpy().view(np.uint32), depth, n)
    assert np.array_equal(back, src[:n])


@pytest.mark.parametrize("depth", range(9, 16))
def test_wire_pack_kernel_extremes(cuda, depth):
    """All-ones and all-zeros samples, and an unaligned start (the scalar
    load path), ragged n."""
    n = 32 * 77 + 5
    for fill in ((1 << depth) - 1, 0):
        flat = torch.full((n + 1,), fill, dtype=torch.int16, device=cuda)
        flat[-1] = 1
        got = wirepack.pack_words(flat, depth).cpu()
        want = wirepack.pack_words_ref(flat[:n].cpu(), depth)
        assert torch.equal(got[:-1], want) and int(got[-1]) == 1
    rng = np.random.default_rng(depth)
    buf = torch.from_numpy(rng.integers(0, 1 << depth, n + 4, dtype=np.uint16)
                           .view(np.int16)).to(cuda)
    for off in (1, 3):
        got = wirepack.pack_words(buf[off:off + n + 1], depth).cpu()
        assert torch.equal(got[:-1], wirepack.pack_words_ref(
            buf[off:off + n].cpu(), depth))
        assert int(got[-1]) == int(buf[off + n])


def _wire_pack_check(flat, depth):
    """One launch of the kernel on `flat` (samples, then the flag) against
    ``pack_words_ref`` on the card, and its flag word."""
    n = flat.numel() - 1
    before = wirepack.pack_words.launches
    got = wirepack.pack_words(flat, depth)
    torch.cuda.synchronize()
    assert wirepack.pack_words.launches == before + 1
    assert got.shape == (wirepack.packed_words_len(n, depth) + 1,)
    assert torch.equal(got[:-1], wirepack.pack_words_ref(flat[:n], depth))
    assert int(got[-1]) == int(flat[n]) & 0xFFFF


@pytest.mark.parametrize("depth", range(9, 16))
def test_wire_pack_kernel_many_waves(cuda, depth):
    """More tiles than 132 SMs x 8 blocks hold at once, plus a ragged
    tail."""
    n = 132 * 8 * WIRE_TILE + 3 * WIRE_TILE + 45
    g = torch.Generator(device=cuda).manual_seed(depth)
    flat = torch.randint(0, 1 << depth, (n + 1,), generator=g,
                         dtype=torch.int16, device=cuda)
    flat[-1] = 1
    _wire_pack_check(flat, depth)


@pytest.mark.parametrize("depth", range(9, 16))
@pytest.mark.parametrize("off", range(1, 8))
def test_wire_pack_kernel_offsets(cuda, depth, off):
    """A slice at every sample offset that leaves the start unaligned to
    16 bytes: every tile takes the scalar path."""
    n = 3 * WIRE_TILE + 100
    rng = np.random.default_rng(depth * 8 + off)
    buf = torch.from_numpy(rng.integers(0, 1 << depth, n + 8,
                                        dtype=np.uint16).view(np.int16))
    buf = buf.to(cuda)
    _wire_pack_check(buf[off:off + n + 1], depth)


def test_wire_pack_kernel_rejects_bad_args(cuda):
    flat = torch.zeros(64, dtype=torch.int16, device=cuda)
    with pytest.raises(ValueError):
        wirepack.pack_words(flat, 16)
    with pytest.raises(TypeError):
        wirepack.pack_words(flat.to(torch.int32), 10)
    with pytest.raises(ValueError):
        wirepack.pack_words(flat.view(8, 8), 10)


@pytest.fixture
def second_card():
    """The second card, with the first one current: a launch that follows
    the runtime's current device instead of its tensors' device meets a
    stream of another card. Skips with fewer than two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    torch.cuda.set_device(0)
    return torch.device("cuda", 1)


def test_kernels_on_a_second_card(second_card):
    """Every kernel, given the second card's tensors, equals its plain
    version: each wrapper launches under its tensors' device."""
    test_cleanup_kernel_matches_ref(second_card, 16, 16, 129, 41)
    test_rct_kernel_matches_ref(second_card, 10, (37, 53))
    for transform, out_dtype in ((DWT97_INT, torch.int16),
                                 (DWT97, torch.uint8)):
        test_ict_kernel_matches_ref(second_card, transform, out_dtype,
                                    (37, 53))
    test_refine_kernel_matches_ref_random(second_card, 16, 16, 130, 32)
    test_wire_pack_kernel_matches_ref(second_card, 10, 100003)
    assert torch.cuda.current_device() == 0


def test_decode_batch_over_the_cards(second_card):
    """``decode_batch(devices=<every card>, require_shard=True)`` and a
    ``Decoder`` on the second card give the single-card batch's bytes and
    the source, with and without the wire pack; the cleanup pair launches
    once a card."""
    from ffmpeg_ht_tpu_torch.models.decoder import Decoder
    from ffmpeg_ht_tpu_torch.models.encoder import encode_frame_htj2k

    rng = np.random.default_rng(8)
    imgs = [rng.integers(0, 1024, (96, 128, 3), dtype=np.uint16)
            for _ in range(5)]
    streams = [encode_frame_htj2k(im, depth=10, mct=True, nreslevels=3,
                                  log2_cblk_width=5, log2_cblk_height=5)
               for im in imgs]
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    for wp in (False, True):
        single = Decoder("cuda:0", wire_pack=wp).decode_batch(streams)
        before = _launches()
        sharded = Decoder("cuda:0", wire_pack=wp).decode_batch(
            streams, devices=cards, require_shard=True)
        assert _launches() == (before[0] + len(cards),
                               before[1] + len(cards))
        on_second = [Decoder(second_card, wire_pack=wp).decode(s)
                     for s in streams]
        for a, b, c, im in zip(single, sharded, on_second, imgs):
            assert a.tobytes() == b.tobytes() == c.tobytes() \
                == (im << 6).tobytes()
    res = Decoder(second_card).bench_resident(streams, n_it=2, reps=1)
    assert res["frames_merged"] == 5 and res["fps"] > 0
    assert torch.cuda.current_device() == 0


# ---- the v3 program's coefficient stages: coef_mosaic and dwt_lift ----

# (image shape, encoder options): a DCI-4K 4:4:4 frame of c3's geometry
# (64x64 codeblocks, 6 levels; zeros encode in seconds and the plan does
# not depend on the content) and two whose codeblocks precincts cut and
# crop
COEF_GEOMS = {
    "c3": ((2160, 4096, 3), dict(depth=10, tile_width=4096, tile_height=4096,
                                 log2_cblk_width=6, log2_cblk_height=6,
                                 mct=True)),
    "prec-gray-32": ((90, 118), dict(nreslevels=3, log2_cblk_width=5,
                                     log2_cblk_height=5, log2_prec_width=6)),
    "prec-rgb-16": ((75, 101, 3), dict(nreslevels=3, log2_cblk_width=4,
                                       log2_cblk_height=4, log2_prec_width=6,
                                       mct=True)),
}
TRANSFORMS = {"53": DWT53, "int": DWT97_INT, "float": DWT97}


def _coef_program(geom, transform, frames, n_extra):
    from ffmpeg_ht_tpu_torch.codestream.parser import parse_codestream
    from ffmpeg_ht_tpu_torch.models import assembly
    from ffmpeg_ht_tpu_torch.models import fastpath
    from ffmpeg_ht_tpu_torch.models.encoder import encode_frame_htj2k

    shape, opts = COEF_GEOMS[geom]
    data = encode_frame_htj2k(np.zeros(shape, np.uint16 if "depth" in opts
                                       else np.uint8), **opts)
    fg = fastpath.FlatGeometry(parse_codestream(data, bitexact=True))
    plan = assembly.build_plan(fg)
    return assembly.V3Program(plan, fg.geom.key()[:-1] + (transform,),
                              qw=plan.bw // 2, qh=plan.bh // 2, ms_class=8,
                              n_pad=plan.n_lanes + n_extra, frames=frames,
                              layout=assembly.FrameLayout.identity(
                                  fg.geom.key()))


def _same_bits(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("tname", list(TRANSFORMS))
@pytest.mark.parametrize("geom", list(COEF_GEOMS))
def test_coef_mosaic_kernel_matches_ref(cuda, geom, tname):
    """Random mu words and lane vectors (magb past 31, istep wrapping
    int32, pad lanes), prefill entries with pads; kernel == plain version
    bit for bit, with and without the identity step."""
    transform = TRANSFORMS[tname]
    prog = _coef_program(geom, transform, 2 if geom != "c3" else 1, 5)
    lay = prog.layout
    N, bh, bw = lay.n_lanes, lay.bh, lay.bw
    rng = np.random.default_rng(len(geom) * 3 + len(tname))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    mu = t(rng.integers(0, 1 << 32, (N, bh, bw), dtype=np.uint64)
           .astype(np.uint32).view(np.int32))
    magb = t(rng.integers(1, 40, N).astype(np.int32))
    istep = t(np.where(rng.random(N) < 0.5, 32768,
                       rng.integers(1, 70000, N)).astype(np.int32))
    s97 = t(rng.integers(0, 1 << 20, N).astype(np.int32))
    fs = t(rng.uniform(0, 1e-3, N).astype(np.float32))
    dt = torch.float32 if transform == DWT97 else torch.int32
    n_pf = 4096
    idx = rng.choice(N * bh * bw, n_pf - 4, replace=False)
    pf_idx = t(np.concatenate([idx, [N * bh * bw] * 4]).astype(np.int32))
    pf_val = t(rng.integers(-5000, 5000, n_pf)).to(dt)
    for no_istep in (False, True):
        args = (mu, magb, istep, s97, fs, pf_idx, pf_val, lay, transform,
                no_istep)
        before = coef_cuda.coef_mosaic.launches
        got = coef_cuda.coef_mosaic(*args)
        torch.cuda.synchronize()
        assert coef_cuda.coef_mosaic.launches == before + 1
        assert _same_bits(got, coef_cuda.coef_mosaic_ref(*args))


def _lift_jobs(rng, cases, transform, cuda):
    """One job per (border, ndec, level): random bands of that level."""
    dt = torch.float32 if transform == DWT97 else torch.int32
    jobs = []
    for border, ndec, lev in cases:
        linelen, mod = dwt_levels(border, ndec)
        (lh, lv), (mh, mv) = linelen[lev], mod[lev]
        nlh, nlv = len(range(mh, lh, 2)), len(range(mv, lv, 2))
        r = lambda s: torch.from_numpy(
            rng.integers(-4000, 4000, s)).to(dt).to(cuda)
        jobs.append((r((nlv, nlh)), r((nlv, lh - nlh)), r((lv - nlv, nlh)),
                     r((lv - nlv, lh - nlh)), mh, mv,
                     transform == DWT97_INT and lev == ndec - 1))
    return jobs


LIFT_GEOMS = {
    # odd origins on both axes, the 8x8 minimum, odd ends
    "odd": [([[1, 41], [3, 43]], 3, lev) for lev in range(3)]
    + [([[0, 32], [0, 32]], 3, 0), ([[3, 70], [0, 37]], 2, 1),
       ([[5, 90], [7, 29]], 2, 0), ([[2, 300], [1, 9]], 1, 0)],
    # a c3 plane's top level, and the three planes of a c2 frame
    "c3": [([[0, 4096], [0, 2160]], 6, 5)],
    "c2": [([[0, 1920], [0, 1080]], 5, 4)] * 3,
    # more jobs than one launch takes, and tall levels (many tiles down)
    "many": [([[1, 41], [3, 43]], 3, 2)] * (dwt_cuda.MAX_JOBS + 2),
    "tall": [([[0, 20], [1, 5001]], 1, 0), ([[1, 66], [0, 1500]], 1, 0)],
    # lines longer than a block's shared memory holds (58 K samples)
    "long": [([[0, 60000], [0, 8]], 1, 0), ([[0, 8], [0, 60000]], 1, 0),
             ([[1, 60002], [1, 9]], 1, 0), ([[1, 10], [1, 60003]], 1, 0)],
}


def _check_lift(jobs, transform):
    before = dwt_cuda.dwt_lift.launches
    got = dwt_cuda.dwt_lift(jobs, transform)
    torch.cuda.synchronize()
    assert dwt_cuda.dwt_lift.launches \
        == before + -(-len(jobs) // dwt_cuda.MAX_JOBS)
    for g, j in zip(got, jobs):
        assert _same_bits(g, dwt_torch.dwt_level_ref(*j[:6], transform,
                                                     j[6]))


@pytest.mark.parametrize("tname", list(TRANSFORMS))
@pytest.mark.parametrize("case", list(LIFT_GEOMS))
def test_dwt_lift_kernel_matches_ref(cuda, case, tname):
    transform = TRANSFORMS[tname]
    rng = np.random.default_rng(len(case) * 5 + len(tname))
    _check_lift(_lift_jobs(rng, LIFT_GEOMS[case], transform, cuda),
                transform)


@pytest.mark.parametrize("mh,mv", [(0, 0), (1, 0), (0, 1), (1, 1)])
@pytest.mark.parametrize("tname", list(TRANSFORMS))
def test_dwt_lift_kernel_edge_set(cuda, tname, mh, mv):
    """Every width and height from 8 to 67, and the tile seams +-1 on both
    axes, at origin parities (mh, mv): one level each (with the final
    shift on the integer 9/7)."""
    transform = TRANSFORMS[tname]
    rows, cols = dwt_cuda.TILE_ROWS, dwt_cuda.tile_cols(transform)
    sizes = [(8 + i, 8 + (7 * i + 3) % 60) for i in range(60)]
    seams = [n + d for n in (rows, 2 * rows) for d in (-1, 0, 1)]
    seams_w = [n + d for n in (cols, 2 * cols) for d in (-1, 0, 1)]
    sizes += [(h, w) for h in seams for w in seams_w[::2]] \
        + [(h, w) for h in seams[::2] for w in seams_w]
    cases = [([[mh, mh + w], [mv, mv + h]], 1, 0) for h, w in sizes]
    rng = np.random.default_rng(mh * 2 + mv + 10 * len(tname))
    _check_lift(_lift_jobs(rng, cases, transform, cuda), transform)


@pytest.mark.parametrize("tname", list(TRANSFORMS))
@pytest.mark.parametrize("geom", list(COEF_GEOMS))
def test_dwt_lift_program_matches_ref_level_by_level(cuda, geom, tname):
    """A V3Program's one dwt_lift_program call on a random band buffer:
    each level of each plane equals dwt_level_ref on that job's inputs
    (the buffer's bands, the call's previous level), and the call
    launches what kernel_launches() says."""
    transform = TRANSFORMS[tname]
    prog = _coef_program(geom, transform, 2, 0)
    rng = np.random.default_rng(len(geom) + 3 * len(tname))
    dt = torch.float32 if transform == DWT97 else torch.int32
    bands = torch.from_numpy(rng.integers(-4000, 4000, prog.layout.total)) \
        .to(dt).to(cuda)
    before = dwt_cuda.dwt_lift.launches
    got = dwt_cuda.dwt_lift_program(prog.lift, bands)
    torch.cuda.synchronize()
    assert dwt_cuda.dwt_lift.launches - before \
        == prog.kernel_launches()["dwt_lift"] == prog.levels
    job = {(i, lev): prog.lift.view(got, j)
           for j, (i, lev, _w, _h) in enumerate(prog.lift.jobs)}
    views = prog.layout.views(bands)
    outs = [views[i] for i in prog._ll]
    for lev in range(prog.levels):
        todo, jobs = prog.level_jobs(lev, outs, views)
        for i, j in zip(todo, jobs):
            assert _same_bits(job[i, lev], dwt_torch.dwt_level_ref(
                *j[:6], transform, j[6]))
            outs[i] = job[i, lev]


def test_dwt_lift_kernel_rejects_bad_args(cuda):
    z = lambda h, w: torch.zeros((h, w), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="dwt_decode_flat"):
        dwt_cuda.dwt_lift([(z(4, 4), z(4, 3), z(3, 4), z(3, 3), 0, 0,
                            False)], DWT53)
    with pytest.raises(ValueError, match="expected cuda"):
        dwt_cuda.dwt_lift([(z(8, 8), z(8, 8).cpu(), z(8, 8), z(8, 8), 0, 0,
                            False)], DWT53)


@pytest.mark.parametrize("mh,mv", [(0, 0), (1, 0), (0, 1), (1, 1)])
@pytest.mark.parametrize("tname", list(TRANSFORMS))
def test_dwt_small_kernel_edge_set(cuda, tname, mh, mv):
    """Every level under 8 in a dimension: each side of 1-7 against the
    other of 1-67 both ways, and lines of 70000 samples, at origin
    parities (mh, mv), a plane of one level each (with the final shift on
    the integer 9/7), bands back to back in one buffer: one
    dwt_lift_program call is one dwt_small launch, by bits against
    dwt_lift_program_ref (dwt_level_small_ref job by job)."""
    transform = TRANSFORMS[tname]
    sizes = [(a, b) for a in range(1, 8) for b in range(1, 68)]
    sizes += [(b, a) for a, b in sizes if b >= 8]
    sizes += [(5, 70000), (70000, 5), (70000, 3), (1, 70000), (70000, 1)]
    shapes, planes = [], []
    for w, h in sizes:
        nE, nEv = (w + 1 - mh) // 2, (h + 1 - mv) // 2
        b = len(shapes)
        shapes += [(nEv, nE), (nEv, w - nE), (h - nEv, nE),
                   (h - nEv, w - nE)]
        planes.append((b, [(b + 1, b + 2, b + 3)], [(mh, mv)]))
    offsets = np.cumsum([0] + [r * c for r, c in shapes])[:-1].tolist()
    plan = dwt_cuda.LiftPlan(offsets, shapes, planes, transform)
    assert len(plan.small_table) == len(sizes) and not len(plan.table)
    # the five long lines in device memory, the others staged in shared
    # memory
    assert plan.small_device == 5 and plan.small_shared == len(sizes) - 5
    dt = torch.float32 if transform == DWT97 else torch.int32
    rng = np.random.default_rng(mh * 2 + mv + 20 * len(tname))
    buf = torch.from_numpy(rng.integers(-4000, 4000, plan.band_total)) \
        .to(dt).to(cuda)
    before = (dwt_cuda.dwt_lift.launches, dwt_cuda.dwt_small.launches)
    got = dwt_cuda.dwt_lift_program(plan, buf)
    torch.cuda.synchronize()
    assert (dwt_cuda.dwt_lift.launches - before[0],
            dwt_cuda.dwt_small.launches - before[1]) == (0, 1)
    assert _same_bits(got, dwt_cuda.dwt_lift_program_ref(plan, buf.cpu())
                      .to(cuda))


FLAT_PLANES = {
    # (h, w) planes of one flat buffer with their borders and levels: the
    # 8K frame's bottom tiles (lowest levels 32x7 and 16x7), odd origins
    # with two small levels, a plane of small levels only, an empty level
    # (a side of 0), and one without levels
    "c4": [((224, 1024), ((0, 1024), (4096, 4320)), 6),
           ((224, 512), ((7168, 7680), (4096, 4320)), 6)],
    "odd": [((37, 45), ((3, 48), (1, 38)), 3),
            ((6, 70), ((1, 71), (0, 6)), 2),
            ((1, 5), ((5, 10), (9, 10)), 3),
            ((13, 1), ((7, 8), (2, 15)), 2),
            ((9, 9), ((0, 9), (0, 9)), 0)],
    # chains of small levels whose later levels do not fit dwt_small's
    # shared memory: a staged prefix, the rest in device memory
    "mixed": [((3000, 6), ((1, 7), (3, 3003)), 2),
              ((5, 9000), ((0, 9000), (1, 6)), 3),
              ((7, 7), ((1, 8), (1, 8)), 3)],
}


def _flat_program(geom, transform):
    """(the flat LiftPlan of FLAT_PLANES[geom], planes one after another in
    one buffer with a trailing slot)."""
    from ffmpeg_ht_tpu_torch.models.assembly import flat_lift_plan
    planes, off = [], 0
    for (h, w), _b, _n in FLAT_PLANES[geom]:
        planes.append((off, h, w))
        off += h * w
    return flat_lift_plan(planes, [b for _s, b, _n in FLAT_PLANES[geom]],
                          [n for _s, _b, n in FLAT_PLANES[geom]], transform,
                          off + 1)


@pytest.mark.parametrize("tname", list(TRANSFORMS))
@pytest.mark.parametrize("geom", list(FLAT_PLANES))
def test_flat_dwt_program_matches_ref(cuda, geom, tname):
    """A flat buffer's quadrant pyramids through one dwt_lift_program
    call: dwt_small for the levels under 8x8, then dwt_lift on strided
    jobs (the bands are corners of each plane, rows at its width), equal
    by bits to dwt_lift_program_ref, with the plan's launches."""
    transform = TRANSFORMS[tname]
    plan = _flat_program(geom, transform)
    dt = torch.float32 if transform == DWT97 else torch.int32
    rng = np.random.default_rng(len(geom) + 7 * len(tname))
    flat = torch.from_numpy(rng.integers(-4000, 4000, plan.band_total)) \
        .to(dt).to(cuda)
    before = (dwt_cuda.dwt_lift.launches, dwt_cuda.dwt_small.launches)
    got = dwt_cuda.dwt_lift_program(plan, flat)
    torch.cuda.synchronize()
    assert (dwt_cuda.dwt_lift.launches - before[0],
            dwt_cuda.dwt_small.launches - before[1]) \
        == (plan.lift_launches, plan.small_launches)
    assert plan.small_launches == 1
    assert bool(plan.small_device) == (geom == "mixed")
    assert _same_bits(got, dwt_cuda.dwt_lift_program_ref(plan, flat.cpu())
                      .to(cuda))


@pytest.mark.parametrize("tname", list(TRANSFORMS))
def test_dwt_lift_kernel_strided_jobs(cuda, tname):
    """dwt_lift on jobs whose bands are corners of larger planes (rows at
    the plane's stride, as a flat buffer holds them), at every parity:
    by bits against dwt_level_ref on the same views."""
    transform = TRANSFORMS[tname]
    dt = torch.float32 if transform == DWT97 else torch.int32
    rng = np.random.default_rng(40 + len(tname))
    jobs = []
    for (w, h), (mh, mv), pw in (((8, 8), (0, 0), 9), ((300, 41), (1, 0), 301),
                                 ((33, 260), (0, 1), 100),
                                 ((255, 17), (1, 1), 4000)):
        plane = torch.from_numpy(rng.integers(-4000, 4000, (h + 3, pw))) \
            .to(dt).to(cuda)
        nE, nEv = (w + 1 - mh) // 2, (h + 1 - mv) // 2
        jobs.append((plane[:nEv, :nE], plane[:nEv, nE:w], plane[nEv:h, :nE],
                     plane[nEv:h, nE:w], mh, mv, transform == DWT97_INT))
    _check_lift(jobs, transform)


def _scatter_case(rng, transform, cuda):
    """Random buckets (pad lanes, a bucket of no lanes, codeblocks smaller
    than their rasters) at disjoint destinations of a flat buffer, and a
    prefill of which some entries meet lane samples: (args of
    bucket_scatter, the prefill entries under a lane)."""
    total = 60000
    used = np.zeros(total, bool)
    dt = torch.float32 if transform == DWT97 else torch.int32
    t = lambda a: torch.from_numpy(a).to(cuda)
    mus, dims, lanes = [], [], []
    for bw, bh, w, h, n in ((8, 8, 8, 8, 40), (8, 4, 5, 3, 33),
                            (64, 64, 64, 61, 3), (4, 4, 4, 4, 0),
                            (32, 16, 31, 16, 9)):
        dest, stride = np.full(n, -1, np.int32), np.zeros(n, np.int32)
        for i in range(n):
            if i % 5 == 4:
                continue                          # a pad lane
            for _try in range(100):
                st = int(rng.integers(w, w + 40))
                d = int(rng.integers(0, total - (h - 1) * st - w))
                idx = (d + np.arange(h)[:, None] * st
                       + np.arange(w)[None]).ravel()
                if not used[idx].any():
                    used[idx] = True
                    dest[i], stride[i] = d, st
                    break
        mus.append(t(rng.integers(-2 ** 31, 2 ** 31, (n, bh, bw),
                                  dtype=np.int64).astype(np.int32)))
        dims.append((w, h))
        lanes.append(dict(
            dest=t(dest), stride=t(stride),
            magb=t(rng.integers(0, 40, n).astype(np.int32)),
            istep=t(np.where(rng.random(n) < 0.3, 32768,
                             rng.integers(0, 70000, n)).astype(np.int32)),
            scale97=t(rng.integers(-70000, 70000, n).astype(np.int32)),
            fscale=t((rng.random(n) * 1e-6).astype(np.float32))))
    idx = np.unique(np.concatenate([rng.choice(total, 2000, replace=False),
                                    [total]]))
    pf_idx = t(idx.astype(np.int32))
    pf_val = t(rng.integers(-9999, 9999, len(idx))).to(dt)
    return (mus, dims, lanes, pf_idx, pf_val, total), \
        int(used[idx[idx < total]].sum())


@pytest.mark.parametrize("tname", list(TRANSFORMS))
def test_bucket_scatter_kernel_matches_ref(cuda, tname):
    """bucket_scatter against bucket_scatter_ref by bits in all three
    transforms, with and without the step: random mu words, shifts past
    31, wrapping steps, pad lanes, cropped codeblocks, and prefill
    entries under lane samples (the lanes win in both)."""
    transform = TRANSFORMS[tname]
    args, met = _scatter_case(np.random.default_rng(50 + len(tname)),
                              transform, cuda)
    assert met > 0
    for no_istep in (False, True):
        before = coef_cuda.bucket_scatter.launches
        got = coef_cuda.bucket_scatter(*args, transform, no_istep)
        torch.cuda.synchronize()
        assert coef_cuda.bucket_scatter.launches == before + 1
        assert _same_bits(got, coef_cuda.bucket_scatter_ref(
            *args, transform, no_istep))


def _scatter_layout(rng, transform, cuda, layout):
    """Buckets for bucket_scatter at disjoint places of a flat buffer,
    most of which no lane covers (zeros): "aligned" destinations and
    strides (16-byte stores), "unaligned" ones (4-byte stores), or
    "many" buckets (more than two launches), with a prefill of which
    some entries meet lane samples. (args of bucket_scatter, the bucket
    launches expected, the prefill entries under a lane)."""
    total = 200000
    used = np.zeros(total, bool)
    dt = torch.float32 if transform == DWT97 else torch.int32
    t = lambda a: torch.from_numpy(a).to(cuda)
    specs = [(64, 64, 64, 64, 6), (64, 64, 61, 37, 5), (32, 32, 32, 32, 9),
             (16, 8, 13, 8, 11), (8, 4, 7, 3, 13), (4, 4, 4, 4, 7),
             (256, 16, 256, 16, 2), (2, 2, 1, 1, 5)]
    if layout == "many":
        specs = [(8, 8, 5 + i % 4, 8 - i % 5, 4)
                 for i in range(2 * coef_cuda.MAX_BUCKETS + 5)]
    mus, dims, lanes = [], [], []
    for bw, bh, w, h, n in specs:
        dest, stride = np.full(n, -1, np.int32), np.zeros(n, np.int32)
        for i in range(n):
            if i % 4 == 3:
                continue                          # a pad lane
            for _try in range(200):
                st = int(rng.integers(w, w + 80))
                d = int(rng.integers(0, total - (h - 1) * st - w))
                if layout == "aligned":
                    st, d = (st + 3) & ~3, d & ~3
                elif layout == "unaligned":
                    st, d = st | 1, d | 1
                idx = (d + np.arange(h)[:, None] * st
                       + np.arange(w)[None]).ravel()
                if idx.max() < total and not used[idx].any():
                    used[idx] = True
                    dest[i], stride[i] = d, st
                    break
        mus.append(t(rng.integers(-2 ** 31, 2 ** 31, (n, bh, bw),
                                  dtype=np.int64).astype(np.int32)))
        dims.append((w, h))
        lanes.append(dict(
            dest=t(dest), stride=t(stride),
            magb=t(rng.integers(0, 40, n).astype(np.int32)),
            istep=t(np.where(rng.random(n) < 0.3, 32768,
                             rng.integers(0, 70000, n)).astype(np.int32)),
            scale97=t(rng.integers(-70000, 70000, n).astype(np.int32)),
            fscale=t((rng.random(n) * 1e-6).astype(np.float32))))
    idx = np.unique(np.concatenate([rng.choice(total, 5000, replace=False),
                                    [total]]))
    pf_idx = t(idx.astype(np.int32))
    pf_val = t(rng.integers(-9999, 9999, len(idx))).to(dt)
    return (mus, dims, lanes, pf_idx, pf_val, total), \
        coef_cuda.bucket_scatter_launches(len(specs)), \
        int(used[idx[idx < total]].sum())


@pytest.mark.parametrize("layout", ["aligned", "unaligned", "many"])
@pytest.mark.parametrize("tname", list(TRANSFORMS))
def test_bucket_scatter_kernel_layouts(cuda, tname, layout):
    """bucket_scatter against bucket_scatter_ref by bits on a buffer most
    of which no lane covers: 16-byte aligned destinations and strides,
    odd ones, and more buckets than two launches take (the counter adds
    one a launch); prefill entries under lane samples lose to the lanes,
    the others are written, and the rest reads 0."""
    transform = TRANSFORMS[tname]
    args, launches, met = _scatter_layout(
        np.random.default_rng(80 + len(tname) + len(layout)), transform,
        cuda, layout)
    assert met > 0 and launches == (3 if layout == "many" else 1)
    before = coef_cuda.bucket_scatter.launches
    got = coef_cuda.bucket_scatter(*args, transform, False)
    torch.cuda.synchronize()
    assert coef_cuda.bucket_scatter.launches == before + launches
    assert _same_bits(got, coef_cuda.bucket_scatter_ref(*args, transform,
                                                        False))


@pytest.mark.parametrize("out_dtype,cbps", [(torch.uint8, 8),
                                            (torch.uint8, 5),
                                            (torch.int16, 10),
                                            (torch.int16, 16),
                                            (torch.int32, 12)])
@pytest.mark.parametrize("src", ["int", "float"])
def test_plane_writeframe_kernel_matches_ref(cuda, src, out_dtype, cbps):
    """plane_writeframe against plane_writeframe_ref: planes from two
    buffers at any offset, ragged sizes, an empty plane, exact .5 ties of
    float samples, values far past the clip, and more planes than one
    launch takes."""
    rng = np.random.default_rng(60 + cbps)
    dt = torch.float32 if src == "float" else torch.int32
    bufs = [torch.from_numpy(rng.normal(0, 40000, n)).to(dt).to(cuda)
            for n in (300000, 200000)]
    if src == "float":
        bufs[0][:64] = torch.arange(64, device=cuda) - 32.5
    planes, offs, pos = [], [], 0
    for k in range(mct_cuda.MAX_PLANES + 7):
        b = bufs[k % 2]
        n = int(rng.integers(0, 3000)) if k % 11 else 4097
        o = int(rng.integers(0, b.numel() - n))
        planes.append(b[o:o + n])
        offs.append(mct_cuda.back_to_back((1, n), 1, pos)[0])
        pos += n + int(rng.integers(0, 3))
    want = mct_cuda.plane_writeframe_ref(
        planes, cbps, torch.zeros(pos, dtype=out_dtype, device=cuda), offs)
    got = torch.zeros(pos, dtype=out_dtype, device=cuda)
    before = mct_cuda.plane_writeframe.launches
    mct_cuda.plane_writeframe(planes, cbps, got, offs)
    torch.cuda.synchronize()
    assert mct_cuda.plane_writeframe.launches == before + 2
    assert torch.equal(got, want)


def _program_stream(route, tname):
    """A 96x128 stream of `route`: "band" (3 resolution levels, every DWT
    level at least 8x8), "flat" (6: levels under 8x8, a V3Program) or
    "v2" (6, two HT layers: a BucketProgram), RGB with MCT except v2's
    gray, so that every plane of v2 goes through plane_writeframe."""
    from ffmpeg_ht_tpu_torch.models.encoder import encode_frame_htj2k

    rng = np.random.default_rng(12)
    img = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
    opts = dict(pred=int(tname == "53"), log2_cblk_width=5,
                log2_cblk_height=5, nreslevels=3 if route == "band" else 6)
    if route == "v2":
        return encode_frame_htj2k(img[:, :, 0], refinement=True, ht_layers=2,
                                  **opts)
    return encode_frame_htj2k(img, mct=True, **opts)


# what one decode of _program_stream(route) launches: coef_mosaic,
# bucket_scatter, dwt_lift (the 96x128 plane's levels of at least 8x8:
# 2 with 3 resolution levels, 4 with 6), dwt_small (once for the 6x8
# level), plane_writeframe (once for v2's gray plane; MCT takes RGB)
PROGRAM_LAUNCHES = {"band": [1, 0, 2, 0, 0], "flat": [1, 0, 4, 1, 0],
                    "v2": [0, 1, 4, 1, 1]}


@pytest.mark.parametrize("route", ["band", "flat", "v2"])
@pytest.mark.parametrize("tname", list(TRANSFORMS))
def test_v3_program_on_the_card_runs_no_plain_stage(cuda, tname, route,
                                                   monkeypatch):
    """A V3Program (band-direct, or with levels under 8x8) or a
    BucketProgram on CUDA tensors launches its kernels (coef_mosaic or
    bucket_scatter once, dwt_small once for the levels under 8x8,
    dwt_lift once a level, plane_writeframe for the planes without MCT),
    exactly PROGRAM_LAUNCHES[route], which is what the program's
    kernel_launches() says, and reaches neither the dequant, the prefill,
    the mosaics, the scatter, the DC shift, nor the torch lifting (each
    made to raise), giving the CPU decoder's bytes."""
    from ffmpeg_ht_tpu_torch.models import assembly
    from ffmpeg_ht_tpu_torch.models.decoder import Decoder

    data = _program_stream(route, tname)
    bitexact = tname != "float"
    want = Decoder(device="cpu", bitexact=bitexact).decode(data).tobytes()

    def refuse(*_a, **_k):
        raise AssertionError("a plain stage ran on the card")
    for mod, name in ((coef_cuda, "coef_mosaic_ref"), (coef_cuda, "dequant"),
                      (coef_cuda, "prefill"), (coef_cuda, "mosaic_band"),
                      (coef_cuda, "bucket_scatter_ref"),
                      (dwt_cuda, "dwt_lift_program_ref"),
                      (dwt_torch, "dwt_level_ref"),
                      (dwt_torch, "dwt_level_small_ref"),
                      (dwt_torch, "dwt_decode_bands"),
                      (dwt_torch, "dwt_decode_flat"),
                      (mct_cuda, "dc_shift_clip"),
                      (mct_cuda, "plane_writeframe_ref")):
        monkeypatch.setattr(mod, name, refuse)
    for table in (dwt_torch._POLY_SR, dwt_torch._SR):
        for k in list(table):
            monkeypatch.setitem(table, k, refuse)
    progs, pack = [], assembly._Program.pack
    monkeypatch.setattr(assembly._Program, "pack",
                        lambda self, *a: progs.append(self) or pack(self, *a))
    names = ("coef_mosaic", "bucket_scatter", "dwt_lift", "dwt_small",
             "plane_writeframe")
    counters = (coef_cuda.coef_mosaic, coef_cuda.bucket_scatter,
                dwt_cuda.dwt_lift, dwt_cuda.dwt_small,
                mct_cuda.plane_writeframe)
    dec = Decoder(device=cuda, bitexact=bitexact)
    before = [f.launches for f in counters]
    got = dec.decode(data).tobytes()
    launched = [f.launches - b for f, b in zip(counters, before)]
    assert (dec.v3_frames, dec.v2_frames) == ((0, 1) if route == "v2"
                                              else (1, 0))
    assert len(progs) == 1
    assert type(progs[0]).__name__ == ("BucketProgram" if route == "v2"
                                       else "V3Program")
    assert launched == PROGRAM_LAUNCHES[route] \
        == [progs[0].kernel_launches()[k] for k in names]
    assert got == want


# c3's coding (BASELINE config 3: 10-bit 4:4:4, RCT, one tile, 64x64
# codeblocks, 6 DWT levels) on a quarter of its 4096x2160 frame
C3_LIKE_ENC = dict(depth=10, mct=True, tile_width=4096, tile_height=4096,
                   log2_cblk_width=6, log2_cblk_height=6)


@pytest.fixture(scope="module")
def c3_like():
    """Five c3-like frames of distinct 10-bit noise: (sources, streams)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card (torch.cuda.is_available() is False)")
    from ffmpeg_ht_tpu_torch.models.encoder import encode_frame_htj2k

    rng = np.random.default_rng(23)
    srcs = [rng.integers(0, 1024, (1080, 2048, 3), dtype=np.uint16)
            for _ in range(5)]
    return srcs, [encode_frame_htj2k(s, **C3_LIKE_ENC) for s in srcs]


def test_staged_upload_is_not_overwritten_by_the_next_staging(cuda,
                                                              c3_like):
    """Two v3 program calls staged back to back while the stream is held
    (``torch.cuda._sleep``), each letting its page-locked buffer go before
    its copy has run: the second staging takes another block, both
    copies' device arguments equal their numpy arrays once the stream
    runs, and once the copies are done the host cache hands one of the
    two blocks out again."""
    from ffmpeg_ht_tpu_torch.codestream.parser import parse_codestream
    from ffmpeg_ht_tpu_torch.models import fastpath as FP

    _srcs, streams = c3_like
    hdrs = [parse_codestream(d) for d in streams[:2]]
    fg = FP.FlatGeometry(hdrs[0])
    cols = [FP.build_v3_frame(fg, FP.parse_frame_flat(h, fg)) for h in hdrs]
    want = [FP.finish_v3_numpy(fg, [c], fg.geom.total)[0] for c in cols]

    def stage(fc):
        s = FP.Staging(cuda)
        FP.finish_v3_numpy(fg, [fc], fg.geom.total, s.alloc)
        ptr = s.host.data_ptr()
        return s.views(FP.to_torch(s.host, cuda), 1), ptr

    stage(cols[0])                      # the first block, allocated warm
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)    # ~0.5 s of the stream held
    (a0, p0), (a1, p1) = stage(cols[0]), stage(cols[1])
    held = torch.cuda.Event()
    held.record()
    assert not held.query()             # both copies were still queued
    assert p0 != p1
    torch.cuda.synchronize()
    for got, w in zip((a0, a1), want):
        assert list(got) == list(w)
        for k, v in w.items():
            g = got[k].cpu().numpy().view(v.dtype)
            assert g.shape == v.shape and np.array_equal(g, v), k
    assert not torch.equal(a0["msw"], a1["msw"])  # an overwrite shows
    _a2, p2 = stage(cols[1])
    assert p2 in (p0, p1)


def test_decode_stream_of_c3_like_frames_equals_the_sources(cuda, c3_like):
    """``decode_stream`` at depth 3 over five c3-like frames, each call's
    arguments staged in page-locked memory that the next calls' staging
    may reuse once its copy is done: every frame equals its source
    (rgb48le, 10 bits shifted left by 6), through the v3 program, and each
    frame was staged once."""
    from ffmpeg_ht_tpu_torch.models.decoder import Decoder
    from ffmpeg_ht_tpu_torch.utils import trace

    srcs, streams = c3_like
    dec = Decoder(device=cuda)
    f0 = trace.counters.get("staged_frames", 0)
    frames = list(dec.decode_stream(streams + streams[:2], depth=3))
    assert dec.v3_frames == 7 and not dec.v2_frames and not dec.host_frames
    assert trace.counters["staged_frames"] - f0 == 7
    for frame, src in zip(frames, srcs + srcs[:2]):
        assert frame.fmt.name == "rgb48le"
        assert frame.tobytes() == (src << 6).tobytes()
