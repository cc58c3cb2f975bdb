"""The conformance corpus through the port on the CPU.

One case per stream: ``ffmpeg_ht_tpu_torch``'s ``Decoder(device="cpu")``
must return the bytes of the JAX package's host oracle
(``ffmpeg_ht_tpu.models.host_decoder.decode_frame``, numpy and native C,
the decoder the JAX suite holds against ``ffmpeg``), within 1 LSB for
float 9/7; the source wherever the stream is lossless; the golden
framecrc of ``tests/ref/fate-<name>`` for the FATE streams; and it must
take the stream's expected route (``v3_frames``, ``v2_frames``,
``host_frames``) with the expected calls of each kernel's plain version
(on the card, the kernel launches the same count).

The corpus: the ten codestreams of ``tests/test_fate.py:_corpus()``; the
device-path streams of the JAX suite's conformance tests (PPT / PPM,
POC, precincts, RPCL, placeholder passes, lowres, signed samples, ROI,
``ht_mixed``, ``max_layers``, 128x32 codeblocks), with the same encoder
options and seeded images of their own; and the streams that launch the
kernels the FATE set does not (RCT, ICT in both modes, the wire pack).
``chip_smoke.py`` phase 10 runs a copy of this corpus on the card;
``test_chip_smoke_holds_the_same_corpus`` pins the copy. The JAX
``Decoder`` on two of these streams: tests/test_torch_conformance_jax.py;
bit-flip mutants: tests/test_torch_conformance_mutants.py.
"""

import collections
import dataclasses
import importlib
import os
import sys

import numpy as np
import pytest

from ffmpeg_ht_tpu.models import host_decoder as jax_host
from ffmpeg_ht_tpu_torch.containers import mux
from ffmpeg_ht_tpu_torch.models import fastpath as port_fp
from ffmpeg_ht_tpu_torch.models.decoder import Decoder
from ffmpeg_ht_tpu_torch.models.encoder import (encode_frame_htj2k,
                                                encode_frame_t800)
from ffmpeg_ht_tpu_torch.codestream.parser import parse_codestream
from ffmpeg_ht_tpu_torch.ops import (coef_cuda, dwt_cuda, ht_refine, ht_scan,
                                     mct_cuda, wirepack)
from test_fate import _corpus as fate_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_DIR = os.path.join(REPO, "tests", "ref")

# `launches` counts, in this order, the HT cleanup pair (one VLC and one
# MagSgn launch each), the refinement pair (SigProp then MagRef), RCT,
# ICT, the wire pack, coef_mosaic, dwt_lift (a launch a DWT level of at
# least 8x8), dwt_small (a launch for the levels under 8x8),
# bucket_scatter and plane_writeframe
KERNELS = ("cleanup", "refine", "rct", "ict", "wire_pack", "coef", "lift",
           "small", "scatter", "write")
ROUTES = {"v3": (1, 0, 0), "v2": (0, 1, 0), "host": (0, 0, 1)}
POC = [(0, 0, 2, 2, 1, "lrcp"), (2, 0, 2, 33, 1, "rlcp")]
SMALL = dict(nreslevels=3, log2_cblk_width=5, log2_cblk_height=5)

Case = collections.namedtuple(
    "Case", "name kind img enc dec route launches lossless golden")


def _noise(seed, shape, hi=256, dtype=np.uint8):
    return np.random.default_rng(seed).integers(0, hi, shape, dtype=dtype)


def _lowamp(seed, h, w, amp):
    """Low-amplitude content around mid-scale (an all-background ROI
    shift stays lossless on it)."""
    rng = np.random.default_rng(seed)
    return (128 + rng.integers(-amp, amp + 1, (h, w))).astype(np.uint8)


def _corpus():
    """[Case]: the FATE streams, then the tail."""
    # the FATE streams' routes and launches by KERNELS
    fate = {
        "ht-gray-64": ("v3", (1, 0, 0, 0, 0, 1, 4, 1, 0, 1)),
        "ht-gray-odd": ("v3", (1, 0, 0, 0, 0, 1, 3, 1, 0, 1)),
        "ht-rgb": ("v3", (1, 0, 0, 0, 0, 1, 3, 1, 0, 1)),
        "ht-16bit": ("v3", (1, 0, 0, 0, 0, 1, 3, 1, 0, 1)),
        "ht-smooth": ("v3", (1, 0, 0, 0, 0, 1, 4, 1, 0, 1)),
        "ht-3pass": ("v2", (2, 2, 0, 0, 0, 0, 4, 1, 1, 1)),
        "ht-tiled": ("v3", (1, 0, 0, 0, 0, 1, 4, 1, 0, 1)),
        "j2k-53": ("host", (0, 0, 0, 0, 0, 0, 0, 0, 0, 0)),
        "j2k-97int": ("host", (0, 0, 0, 0, 0, 0, 0, 0, 0, 0)),
        "j2k-layers": ("host", (0, 0, 0, 0, 0, 0, 0, 0, 0, 0)),
    }
    cases = [Case(name, kind, img, opts, {}, *fate[name],
                  opts.get("pred", 1) == 1, True)
             for name, kind, img, opts in fate_corpus()]
    rgb3 = [_noise(10 + i, (80, 112)) for i in range(3)]
    signed = np.random.default_rng(18).integers(-512, 512, (128, 128),
                                                dtype=np.int16)
    for name, img, enc, dec, route, launches, lossless in (
            ("ppt", _noise(1, (96, 128)), dict(ppt=True), {}, "v3",
             (1, 0, 0, 0, 0, 1, 4, 1, 0, 1), True),
            ("ppt-multitile-layers-eph", _noise(2, (80, 112, 3)),
             dict(tile_width=64, tile_height=64, ppt=True, eph=True,
                  refinement=True, ht_layers=2), {}, "v2",
             (2, 2, 0, 0, 0, 0, 4, 1, 1, 1), True),
            ("ppt-sop", _noise(3, (96, 128)),
             dict(ppt=True, sop=True, eph=True), {}, "v3",
             (1, 0, 0, 0, 0, 1, 4, 1, 0, 1), True),
            ("ppt-tile-parts", _noise(4, (96, 128)),
             dict(ppt=True, tp_interval=3), {}, "v3",
             (1, 0, 0, 0, 0, 1, 4, 1, 0, 1), True),
            ("ppm", _noise(5, (96, 128)), dict(ppm=True), {}, "v3",
             (1, 0, 0, 0, 0, 1, 4, 1, 0, 1), True),
            ("ppm-multitile", _noise(6, (80, 112, 3)),
             dict(tile_width=48, tile_height=48, ppm=True), {}, "v2",
             (1, 0, 0, 0, 0, 0, 3, 1, 1, 1), True),
            ("ppt-poc-layers", _noise(7, (96, 128)),
             dict(ppt=True, refinement=True, ht_layers=2, nreslevels=4,
                  poc=POC), {}, "v2", (2, 2, 0, 0, 0, 0, 3, 0, 1, 1), True),
            ("precincts", _noise(8, (96, 128)), dict(log2_prec_width=6), {},
             "v3", (1, 0, 0, 0, 0, 1, 4, 1, 0, 1), True),
            ("rpcl-layers-precincts", _noise(9, (96, 128)),
             dict(refinement=True, ht_layers=2, log2_prec_width=6,
                  prog="rpcl"), {}, "v2",
             (2, 2, 0, 0, 0, 0, 4, 1, 1, 1), True),
            ("rgb-layers-multitile", rgb3,
             dict(chroma_shift=(0, 0), refinement=True, ht_layers=2,
                  tile_width=64, tile_height=64, log2_prec_width=5), {},
             "v2", (2, 2, 0, 0, 0, 0, 4, 1, 1, 1), True),
            ("plhd-3layer", _noise(13, (96, 128)),
             dict(refinement=True, ht_layers=3), {}, "v2",
             (2, 2, 0, 0, 0, 0, 4, 1, 1, 1),
             True),
            ("plhd-single-16", _noise(14, (96, 128)),
             dict(refinement=True, ht_plhd_single=True), {}, "v2",
             (2, 2, 0, 0, 0, 0, 4, 1, 1, 1), True),
            # 8x8 codeblocks are under the host area: every lane decodes
            # on the host inside the fast lane, and no entropy kernel
            # launches; the flat buffer is the prefill alone (no bucket
            # launch), then the DWT and the write-out
            ("plhd-single-8", _noise(14, (96, 128)),
             dict(refinement=True, ht_plhd_single=True, log2_cblk_width=3,
                  log2_cblk_height=3), {}, "v2",
             (0, 0, 0, 0, 0, 0, 4, 1, 0, 1), True),
            ("lowres-r1", _noise(15, (96, 128)), dict(nreslevels=5),
             dict(reduction_factor=1), "v3",
             (1, 0, 0, 0, 0, 1, 3, 0, 0, 1), False),
            ("lowres-r2", _noise(15, (96, 128)), dict(nreslevels=5),
             dict(reduction_factor=2), "v3",
             (1, 0, 0, 0, 0, 1, 2, 0, 0, 1), False),
            ("lowres-rgb-multitile-prec", _noise(16, (80, 112, 3)),
             dict(tile_width=64, tile_height=64, nreslevels=4,
                  log2_prec_width=5, mct=True), dict(reduction_factor=1),
             "v3", (1, 0, 4, 0, 0, 1, 2, 1, 0, 0), False),
            ("lowres-layers-poc", _noise(17, (96, 128)),
             dict(nreslevels=4, refinement=True, ht_layers=2, poc=POC),
             dict(reduction_factor=1), "v2",
             (2, 2, 0, 0, 0, 0, 2, 0, 1, 1), False),
            ("signed-10bit", signed,
             dict(depth=10, sgnd=True, tile_width=128, tile_height=128,
                  log2_cblk_width=6, log2_cblk_height=6), {}, "v3",
             (1, 0, 0, 0, 0, 1, 5, 1, 0, 1), True),
            ("roi", _lowamp(19, 128, 128, 7),
             dict(roi_shift=9, tile_width=128, tile_height=128,
                  log2_cblk_width=6, log2_cblk_height=6), {}, "host",
             (0, 0, 0, 0, 0, 0, 0, 0, 0, 0), True),
            ("ht-mixed", _noise(20, (64, 80)), dict(ht_mixed=True), {},
             "host", (0, 0, 0, 0, 0, 0, 0, 0, 0, 0), True),
            ("max-layers-1", _noise(21, (96, 128)),
             dict(refinement=True, ht_layers=2), dict(max_layers=1), "v2",
             (2, 0, 0, 0, 0, 0, 4, 1, 1, 1), False),
            ("cblk-128x32", _noise(22, (96, 128)),
             dict(log2_cblk_width=7, log2_cblk_height=5), {}, "host",
             (0, 0, 0, 0, 0, 0, 0, 0, 0, 0), True),
            ("rct-rgb10", _noise(23, (96, 128, 3), 1024, np.uint16),
             dict(depth=10, mct=True, **SMALL), {}, "v3",
             (1, 0, 1, 0, 0, 1, 2, 0, 0, 0),
             True),
            ("ict-int", _noise(24, (96, 128, 3)),
             dict(pred=0, mct=True, **SMALL), dict(bitexact=True), "v3",
             (1, 0, 0, 1, 0, 1, 2, 0, 0, 0), False),
            ("ict-float", _noise(24, (96, 128, 3)),
             dict(pred=0, mct=True, **SMALL), dict(bitexact=False), "v3",
             (1, 0, 0, 1, 0, 1, 2, 0, 0, 0), False),
            ("wire-pack-12", _noise(25, (96, 128), 4096, np.uint16),
             dict(depth=12, **SMALL), dict(wire_pack=True), "v3",
             (1, 0, 0, 0, 1, 1, 2, 0, 0, 1), True)):
        cases.append(Case(name, "ht", img, enc, dec, route, launches,
                          lossless, False))
    return cases


CORPUS = _corpus()
BY_NAME = {c.name: c for c in CORPUS}


def encode(case):
    fn = encode_frame_htj2k if case.kind == "ht" else encode_frame_t800
    return fn(case.img, **case.enc)


def host_options(case):
    """The host oracle's options for a case's decoder options."""
    return dict(bitexact=case.dec.get("bitexact", True),
                reduction_factor=case.dec.get("reduction_factor", 0),
                max_layers=case.dec.get("max_layers", 0))


def source_bytes(case):
    """A lossless case's source in the negotiated pixel format: planes
    interleaved, signed samples offset to unsigned, 9..15-bit samples
    shifted to the top of 16 bits."""
    img = case.img
    if isinstance(img, list):
        img = np.stack(img, -1)
    depth = case.enc.get("depth", img.dtype.itemsize * 8)
    x = img.astype(np.int64)
    if case.enc.get("sgnd"):
        x = x + (1 << (depth - 1))
    if depth <= 8:
        return x.astype(np.uint8).tobytes()
    return (x << (16 - depth)).astype(np.uint16).tobytes()


def max_abs_diff(a: bytes, b: bytes, wide: bool) -> int:
    dt = np.uint16 if wide else np.uint8
    x = np.frombuffer(a, dt).astype(np.int64)
    y = np.frombuffer(b, dt).astype(np.int64)
    assert x.shape == y.shape
    return int(np.abs(x - y).max()) if x.size else 0


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts of the kernels' plain versions called (the cleanup and the
    refinement with at least one lane), by group of KERNELS: on the CPU
    the wrappers call them where a CUDA tensor would launch the kernel;
    a ``dwt_lift_program_ref`` call counts its plan's launches of each
    DWT kernel, a ``bucket_scatter_ref`` or ``plane_writeframe_ref`` call
    its kernel's launches."""
    calls = dict.fromkeys(KERNELS, 0)
    for mod, name, group, lanes in (
            (ht_scan, "vlc_pass_ref", "cleanup", True),
            (ht_refine, "refine_ref", "refine", True),
            (mct_cuda, "rct_writeframe_ref", "rct", False),
            (mct_cuda, "ict_writeframe_ref", "ict", False),
            (wirepack, "pack_words_ref", "wire_pack", False),
            (coef_cuda, "coef_mosaic_ref", "coef", False)):
        def counted(*a, _fn=getattr(mod, name), _group=group, _lanes=lanes):
            if not _lanes or a[0].shape[0]:
                calls[_group] += 1
            return _fn(*a)
        monkeypatch.setattr(mod, name, counted)

    def lifted(plan, bands, _fn=dwt_cuda.dwt_lift_program_ref):
        calls["lift"] += plan.lift_launches
        calls["small"] += plan.small_launches
        return _fn(plan, bands)

    def scattered(mus, *a, _fn=coef_cuda.bucket_scatter_ref):
        calls["scatter"] += coef_cuda.bucket_scatter_launches(
            sum(1 for mu in mus if mu.shape[0]))
        return _fn(mus, *a)

    def written(planes, cbps, out, offsets,
                _fn=mct_cuda.plane_writeframe_ref):
        calls["write"] += mct_cuda.plane_writeframe_launches(
            sum(1 for p in planes if p.numel()))
        return _fn(planes, cbps, out, offsets)
    monkeypatch.setattr(dwt_cuda, "dwt_lift_program_ref", lifted)
    monkeypatch.setattr(coef_cuda, "bucket_scatter_ref", scattered)
    monkeypatch.setattr(mct_cuda, "plane_writeframe_ref", written)
    return calls


@pytest.mark.parametrize("case", CORPUS, ids=[c.name for c in CORPUS])
def test_port_decodes_the_corpus(case, plain_calls):
    data = encode(case)
    dec = Decoder(device="cpu", **case.dec)
    got = dec.decode(data)
    assert (dec.v3_frames, dec.v2_frames, dec.host_frames) == \
        ROUTES[case.route]
    assert tuple(plain_calls[k] for k in KERNELS) == case.launches
    want = jax_host.decode_frame(data, **host_options(case))
    assert dataclasses.astuple(got.fmt) == dataclasses.astuple(want.fmt)
    assert (got.width, got.height) == (want.width, want.height)
    if case.dec.get("bitexact", True):
        assert got.tobytes() == want.tobytes()
    else:
        # float 9/7: within 1 LSB of the host float oracle
        assert max_abs_diff(got.tobytes(), want.tobytes(),
                            got.fmt.name.endswith("le")) <= 1
    if case.lossless:
        assert got.tobytes() == source_bytes(case)
    if case.golden:
        with open(os.path.join(REF_DIR, f"fate-{case.name}")) as f:
            assert mux.framecrc([got]) == f.read()


BATCH_SEEDS = (31, 32, 33)


def batch_images(shape):
    """Three seeded noise frames whose lower half is flat: the codeblocks
    there code no pass, so their lanes are inert (qws = qhs = 0)."""
    imgs = []
    for seed in BATCH_SEEDS:
        img = _noise(seed, shape)
        img[shape[0] // 2:] = seed
        imgs.append(img)
    return imgs


def test_one_batch_is_one_v3_program_with_inert_lanes(plain_calls):
    """decode_batch of three frames of the PPT geometry: one V3Program
    (one cleanup call) whose lanes include inert ones, equal to the three
    single decodes."""
    case = BY_NAME["ppt"]
    streams = [encode(case._replace(img=img))
               for img in batch_images(case.img.shape)]
    for data in streams:
        hdr = parse_codestream(data, bitexact=True)
        fg = port_fp.FlatGeometry(hdr)
        fc = port_fp.build_v3_frame(fg, port_fp.parse_frame_flat(hdr, fg))
        assert 0 < int((fc["qws"] == 0).sum()) < len(fc["qws"])
    dec = Decoder(device="cpu")
    frames = dec.decode_batch(streams)
    assert dec.v3_frames == 3 and not dec.v2_frames and not dec.host_frames
    assert plain_calls["cleanup"] == 1
    singles = [Decoder(device="cpu").decode(s).tobytes() for s in streams]
    assert [f.tobytes() for f in frames] == singles
    assert singles == [jax_host.decode_frame(s, bitexact=True).tobytes()
                       for s in streams]


def test_fate_j2k_dwt_through_the_port(monkeypatch):
    """tests/ref/fate-j2k-dwt, the reference's own DWT artifact, through
    the port's host DWT (its copy of ops/dwt.py)."""
    from ffmpeg_ht_tpu_torch.ops import dwt as port_dwt
    from tools import fate_j2k_dwt as tool
    for k in ("DWT53", "DWT97", "DWT97_INT", "I_PRESHIFT"):
        assert getattr(port_dwt, k) == getattr(tool, k)
    monkeypatch.setattr(tool, "dwtmod", port_dwt)
    with open(os.path.join(REF_DIR, "fate-j2k-dwt")) as f:
        assert tool.run() == f.read()


def _chip_smoke():
    """chip_smoke.py as a module, with the environment it sets restored."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    sys.path.insert(0, REPO)
    try:
        return importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(REPO)
        if env is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES", None)
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = env


def _same_image(a, b):
    if isinstance(a, list) or isinstance(b, list):
        return isinstance(a, list) and isinstance(b, list) \
            and len(a) == len(b) and all(map(_same_image, a, b))
    return a.dtype == b.dtype and np.array_equal(a, b)


def test_chip_smoke_holds_the_same_corpus():
    """chip_smoke.py keeps its own copy of the corpus (it imports nothing
    of tests/): the same streams, options, routes and launches."""
    smoke = _chip_smoke()
    theirs = smoke._conformance_corpus()
    assert [c.name for c in theirs] == [c.name for c in CORPUS]
    for mine, their in zip(CORPUS, theirs):
        assert _same_image(mine.img, their.img), mine.name
        assert (mine.kind, mine.enc, mine.dec, mine.route, mine.launches,
                mine.lossless, mine.golden) == (
            their.kind, their.enc, their.dec, their.route, their.launches,
            their.lossless, their.golden), mine.name
    assert smoke.KERNEL_GROUPS == KERNELS
    assert smoke.BATCH_SEEDS == BATCH_SEEDS
