"""The port's slice end to end on the CPU vs the JAX package.

``ffmpeg_ht_tpu_torch.models.decoder.Decoder(device="cpu")`` must return
the same bytes as ``ffmpeg_ht_tpu``'s host decoder (which the JAX suite
holds byte for byte to its ``Decoder``) and the source image in the
negotiated pixel format, for v3-eligible streams (96x128, nreslevels=3,
32x32 codeblocks: every DWT level takes the band-direct path). Also
pinned: the port's ``finish_v3`` arrays (5/3, integer and float 9/7),
the prefill scatter with its trash slot against the JAX program (one v3
program, the gray stream's) and the layout of tiles at an image offset
against the JAX ``Decoder``'s batch (one v2 program), the routing of
streams outside the slice, and that the port imports neither ``jax`` nor
the JAX package. The frame write: each pixel format's ``frame_layout``
through ``decode``, ``decode_stream`` and ``decode_batch`` against the
JAX package's host decoder (rgb24, rgb48le, gray, gray16le, ya8,
yuv420p, xyz12le, tiles with an image offset, a reduced resolution), the
plain write versions in a layout against ``_write_frame_prescaled``, the
identity layout, and the copy out of the fetched buffer. The 9/7 path,
the flat-DWT fallback and the batch entry points:
tests/test_torch_decoder97.py.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ffmpeg_ht_tpu.codestream.parser import parse_codestream
from ffmpeg_ht_tpu.models import fastpath as FP
from ffmpeg_ht_tpu.models import host_decoder as jax_host
from ffmpeg_ht_tpu.models.decoder import Decoder as JaxDecoder
from ffmpeg_ht_tpu.models.encoder import encode_frame_htj2k, encode_frame_t800
from ffmpeg_ht_tpu.ops.dwt import DWT97_INT
from ffmpeg_ht_tpu_torch.codestream.parser import parse_codestream as \
    port_parse
from ffmpeg_ht_tpu_torch.models import decoder as port_decoder
from ffmpeg_ht_tpu_torch.models import encoder as port_encoder
from ffmpeg_ht_tpu_torch.models import fastpath as port_fp
from ffmpeg_ht_tpu_torch.models import pixfmt
from ffmpeg_ht_tpu_torch.models.assembly import (FrameLayout, V3Program,
                                                 build_plan)
from ffmpeg_ht_tpu_torch.models.decoder import Decoder, frame_layout
from ffmpeg_ht_tpu_torch.ops import ht_scan, mct_cuda
from ffmpeg_ht_tpu_torch.ops.dwt import DWT97_INT
from ffmpeg_ht_tpu_torch.utils import trace
from ffmpeg_ht_tpu_torch.utils.errors import InvalidData

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENC = dict(nreslevels=3, log2_cblk_width=5, log2_cblk_height=5)
RNG = np.random.default_rng(20261016)
IMAGES = {
    "gray8": (RNG.integers(0, 256, (96, 128), dtype=np.uint8), {}),
    "rgb10_rct": (RNG.integers(0, 1024, (96, 128, 3), dtype=np.uint16),
                  dict(depth=10, mct=True)),
    "rgb8_no_mct": (RNG.integers(0, 256, (96, 128, 3), dtype=np.uint8), {}),
    "gray16": (RNG.integers(0, 65536, (96, 128), dtype=np.uint16), {}),
}
STREAMS = {k: encode_frame_htj2k(img, **ENC, **o)
           for k, (img, o) in IMAGES.items()}


@pytest.fixture(scope="module")
def jax_dec():
    return JaxDecoder()


@pytest.fixture(scope="module")
def dec():
    return Decoder(device="cpu")


def _source_bytes(name, fmt_depth):
    img, o = IMAGES[name]
    depth = o.get("depth", img.dtype.itemsize * 8)
    if img.dtype == np.uint16:
        return (img.astype(np.uint16) << (fmt_depth - depth)).tobytes()
    return img.tobytes()


@pytest.mark.parametrize("name", list(IMAGES))
def test_decoder_matches_jax_and_source(name, dec):
    """Lossless streams: the JAX package's host decoder, which its suite
    holds byte for byte to its ``Decoder`` (tests/test_tpu_decoder.py),
    and the source pin the bytes; no JAX program is compiled."""
    data = STREAMS[name]
    v3_before = dec.v3_frames
    launches = (ht_scan.ht_vlc_pass.launches, ht_scan.ht_magsgn_pass.launches,
                mct_cuda.rct_writeframe.launches)
    got = dec.decode(data)
    assert dec.v3_frames == v3_before + 1 and dec.host_frames == 0
    assert launches == (ht_scan.ht_vlc_pass.launches,
                        ht_scan.ht_magsgn_pass.launches,
                        mct_cuda.rct_writeframe.launches)
    want = jax_host.decode_frame(data, bitexact=True)
    # each package has its own PixFmt class: compare the fields
    assert dataclasses.astuple(got.fmt) == dataclasses.astuple(want.fmt)
    assert got.tobytes() == want.tobytes()
    assert got.tobytes() == _source_bytes(name, 8 * got.fmt.bytes_per_sample)


def test_decode_stream_and_async(dec):
    names = list(IMAGES)
    solo = [dec.decode(STREAMS[k]).tobytes() for k in names]
    piped = [f.tobytes() for f in dec.decode_stream(
        [STREAMS[k] for k in names], depth=2)]
    assert piped == solo
    pending = [dec.decode_async(STREAMS[k]) for k in names]
    assert [p().tobytes() for p in pending] == solo


def _v3_frame(data, bitexact=True):
    """(a FlatGeometry of this test's own, the stream's v3 lane columns):
    the JAX Decoder's geometry cache is one per process, shared with
    every test file that runs in the same worker."""
    hdr = parse_codestream(data, bitexact=bitexact)
    fg = FP.FlatGeometry(hdr)
    fc = FP.build_v3_frame(fg, FP.parse_frame_flat(hdr, fg))
    return fg, fc


def _port_v3_frame(data, bitexact=True):
    """The port's own FlatGeometry and v3 lane columns of the stream."""
    hdr = port_parse(data, bitexact=bitexact)
    fg = port_fp.FlatGeometry(hdr)
    return fg, port_fp.build_v3_frame(fg, port_fp.parse_frame_flat(hdr, fg))


def _ms_class(fc):
    mb = int(fc["maxbp"][fc["qws"] > 0].max())
    return next(c for c in (8, 12, 16, 20, 25) if mb <= c)


@pytest.fixture(scope="module")
def lossy_streams():
    """9/7 streams for the lane arguments: integer 9/7 (scale97) and float
    9/7 (fscale) from one lossy gray stream, and an ICT one."""
    img = IMAGES["gray8"][0]
    gray = encode_frame_htj2k(img, pred=0, **ENC)
    ict = encode_frame_htj2k(IMAGES["rgb8_no_mct"][0], pred=0, mct=True,
                             **ENC)
    return [(gray, True), (ict, True), (gray, False)]


def test_finish_v3_matches_jax(lossy_streams):
    """The lane arguments, the state the JAX side hands the device program,
    equal the JAX package's for a 5/3 RCT stream, an integer 9/7 stream
    (scale97 pinned) and a float 9/7 one (fscale pinned), each package
    from its own lane columns of the stream."""
    for data, bitexact in [(STREAMS["rgb10_rct"], True)] + lossy_streams:
        fg, fc = _v3_frame(data, bitexact)
        pfg, pfc = _port_v3_frame(data, bitexact)
        want, F = FP.finish_v3(fg, [fc, fc], fg.geom.total)
        got_np, F2 = port_fp.finish_v3_numpy(pfg, [pfc, pfc],
                                             pfg.geom.total)
        got, _ = port_fp.finish_v3(pfg, [pfc, pfc], pfg.geom.total, "cpu")
        assert F == F2 == 2 and set(want) == set(got_np) == set(got)
        if not bitexact:
            assert np.asarray(want["fscale"]).any()
        elif fg.geom.transform == DWT97_INT:
            assert np.asarray(want["scale97"]).any()
        for k, w in want.items():
            w = np.asarray(w)
            assert got_np[k].dtype == w.dtype, k
            assert np.array_equal(got_np[k], w), k
            t = got[k].numpy()
            if w.dtype == np.uint32:
                t = t.view(np.uint32)
            assert t.dtype == w.dtype and np.array_equal(t, w), k


@pytest.mark.parametrize("case", ["rct53", "ict97-float", "batch3"])
def test_staged_arguments_equal_the_numpy_arrays(case, lossy_streams):
    """``Staging`` on the CPU (the v3 route's one buffer and one copy):
    each argument equals ``finish_v3_numpy``'s array key by key (dtype,
    shape, bytes; uint32 words as int32 bit views), for a 5/3 RCT stream,
    a float 9/7 ICT stream and a batch of three; every argument is a
    contiguous view of one device buffer at a 256-byte aligned offset,
    the host buffer is let go, and the copy counts its frames and
    bytes."""
    if case == "batch3":
        img, o = IMAGES["rgb10_rct"]
        streams, bitexact = [encode_frame_htj2k(np.roll(img, k, 1), **ENC,
                                                **o) for k in (0, 5, 9)], True
    else:
        streams, bitexact = ([STREAMS["rgb10_rct"]], True) \
            if case == "rct53" else ([lossy_streams[1][0]], False)
    hdrs = [port_parse(d, bitexact=bitexact) for d in streams]
    fg = port_fp.FlatGeometry(hdrs[0])
    fcs = [port_fp.build_v3_frame(fg, port_fp.parse_frame_flat(h, fg))
           for h in hdrs]
    want, F = port_fp.finish_v3_numpy(fg, fcs, fg.geom.total)
    stage = port_fp.Staging("cpu")
    host, F2 = port_fp.finish_v3_numpy(fg, fcs, fg.geom.total, stage.alloc)
    nbytes = stage.host.numel()
    f0 = trace.counters.get("staged_frames", 0)
    b0 = trace.counters.get("staged_bytes", 0)
    got = stage.views(port_fp.to_torch(stage.host, "cpu"), F2)
    assert F == F2 == len(streams) and stage.host is None
    assert list(got) == list(host) == list(want)
    if case == "ict97-float":
        assert want["fscale"].any()
    base = got["msw"].untyped_storage().data_ptr()
    for k, w in want.items():
        assert host[k].dtype == w.dtype and np.array_equal(host[k], w), k
        g = got[k]
        assert g.is_contiguous() and g.untyped_storage().data_ptr() == base
        assert (g.data_ptr() - base) % 256 == 0, k
        assert g.dtype == (torch.int32 if w.dtype == np.uint32
                           else torch.from_numpy(w).dtype), k
        g = g.numpy().view(w.dtype)
        assert g.shape == w.shape and g.tobytes() == w.tobytes(), k
    assert got["msw"].untyped_storage().nbytes() == nbytes
    assert trace.counters["staged_frames"] - f0 == F
    assert trace.counters["staged_bytes"] - b0 == nbytes


def test_prefill_scatter_matches_jax(jax_dec):
    """Host-decoded lanes arrive as (pf_idx, pf_val) in lane-raster
    coordinates; pads point one past the frame's rasters (JAX drops them,
    the port writes a trash slot). Same synthetic entries into both
    programs, packed outputs equal."""
    data = STREAMS["gray8"]
    jax_dec.decode(data)                      # builds + caches the program
    fg, fc = _v3_frame(data)
    # the program jax_dec built: its key is (frames, ms_class, no_istep,
    # wire_pack); other tests in this process may have cached others
    jprog = JaxDecoder._fast_geom(parse_codestream(data, bitexact=True)) \
        .v3_progs[(1, _ms_class(fc), True, False)]
    args, F = FP.finish_v3(fg, [fc], fg.geom.total)
    bh, bw = FP.lane_raster_dims(fg)
    span = fg.ncblks * bh * bw
    n_pf = len(np.asarray(args["pf_idx"]))
    rng = np.random.default_rng(5)
    idx = rng.choice(span, n_pf - 3, replace=False)
    pf_idx = np.concatenate([idx, [span] * 3]).astype(np.int32)
    pf_val = rng.integers(-300, 300, n_pf).astype(np.int32)
    import jax.numpy as jnp
    args["pf_idx"], args["pf_val"] = jnp.asarray(pf_idx), jnp.asarray(pf_val)
    want = np.asarray(jprog(**args))
    pfg, pfc = _port_v3_frame(data)
    np_args, _ = port_fp.finish_v3_numpy(pfg, [pfc], pfg.geom.total)
    np_args["pf_idx"], np_args["pf_val"] = pf_idx, pf_val
    plan = build_plan(pfg)
    prog = V3Program(plan, fg.geom.key(), qw=bw // 2, qh=bh // 2,
                     ms_class=_ms_class(fc), n_pad=fg.ncblks, frames=1,
                     layout=FrameLayout.identity(fg.geom.key()),
                     no_istep=True)
    got = prog(**{k: port_fp.to_torch(v, "cpu") for k, v in np_args.items()})
    assert got.dtype == torch.uint8 and got[-1] == 1
    assert np.array_equal(got.numpy(), want)
    plain = np.asarray(jprog(**FP.finish_v3(fg, [fc], fg.geom.total)[0]))
    assert not np.array_equal(plain, want)    # the scatter changed pixels


def test_u_bound_violation_raises_invalid_data(dec):
    """A lane whose U exceeds maxbp clears the packed ok flag, and the
    frame is rejected (decoder.py:1191-1200)."""
    data = STREAMS["gray8"]
    dec.decode(data)
    hdr = port_parse(data, bitexact=True)
    fg = dec._fast_geom(hdr)
    fc = port_fp.build_v3_frame(fg, port_fp.parse_frame_flat(hdr, fg))
    args, _ = port_fp.finish_v3(fg, [fc], fg.geom.total, "cpu")
    args["maxbp"][:] = 1
    # the program dec.decode built: the key holds the frame layout
    layout = dec._layout([hdr], fg.geom)
    prog = fg.v3_progs[(1, _ms_class(fc), True, layout)]
    packed = prog(**args)
    assert packed[-1] == 0
    with pytest.raises(InvalidData):
        dec._finish(hdr, fg.tiles, fg.geom, (packed, layout))


def test_outside_slice_raises_not_host(dec):
    """A stream with refinement passes leaves the v3 lane: it decodes on
    the device through the v2 bucketed path (never on the host oracle),
    equal to the JAX package's host decoder and to the source."""
    img = IMAGES["gray8"][0]
    data = encode_frame_htj2k(img, refinement=True, ht_layers=2, **ENC)
    counts = (dec.v2_frames, dec.v3_frames, dec.host_frames)
    got = dec.decode(data)
    assert (dec.v2_frames, dec.v3_frames, dec.host_frames) == (
        counts[0] + 1, counts[1], counts[2])
    assert got.tobytes() == jax_host.decode_frame(
        data, bitexact=True).tobytes() == img.tobytes()


def test_legacy_stream_takes_host_oracle(dec, jax_dec):
    img = RNG.integers(0, 256, (32, 32), dtype=np.uint8)
    data = encode_frame_t800(img, pred=1)
    host_before = dec.host_frames
    got = dec.decode(data)
    assert dec.host_frames == host_before + 1
    assert got.tobytes() == img.tobytes() == jax_dec.decode(data).tobytes()


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        Decoder(device="cuda")


def test_port_never_imports_jax(tmp_path):
    """In a fresh interpreter, encode with the port's encoder and decode
    with the port's Decoder: neither ``jax`` nor any ``ffmpeg_ht_tpu``
    module may be loaded afterwards."""
    path = tmp_path / "gray8.j2k"
    path.write_bytes(STREAMS["gray8"])
    code = (
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import numpy as np\n"
        "from ffmpeg_ht_tpu_torch.models.decoder import Decoder\n"
        "from ffmpeg_ht_tpu_torch.models.encoder import encode_frame_htj2k\n"
        f"data = open({str(path)!r}, 'rb').read()\n"
        "img = np.random.default_rng(3).integers(0, 1024, (96, 128, 3),\n"
        "                                        dtype=np.uint16)\n"
        f"own = encode_frame_htj2k(img, depth=10, mct=True, **{ENC!r})\n"
        "dec = Decoder(device='cpu')\n"
        "fr = dec.decode(data)\n"
        "assert fr.planes[0].shape == (96, 128), fr.planes[0].shape\n"
        "fr = dec.decode(own)\n"
        "assert (fr.planes[0].reshape(96, 128, 3) == img << 6).all()\n"
        "assert dec.v3_frames == 2\n"
        "assert 'jax' not in sys.modules\n"
        "bad = [m for m in sys.modules if m == 'ffmpeg_ht_tpu'\n"
        "       or m.startswith('ffmpeg_ht_tpu.')]\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-2000:]
    assert "NO_JAX_OK" in res.stdout


# ---- the frame write: each pixel format's layout, written by the program

TINY = dict(nreslevels=2, log2_cblk_width=4, log2_cblk_height=4)


def _dci(data):
    """The stream with Rsiz 4 (DCI 4K profile) in place of 0x4000: 12-bit
    RGB then negotiates xyz12le."""
    b = bytearray(data)
    assert b[6:8] == b"\x40\x00"
    b[6:8] = b"\x00\x04"
    return bytes(b)


def _img(seed, shape, hi=256):
    rng = np.random.default_rng(seed)
    dtype = np.uint8 if hi <= 256 else np.uint16
    if isinstance(shape, list):
        return [rng.integers(0, hi, s, dtype=dtype) for s in shape]
    return rng.integers(0, hi, shape, dtype=dtype)


# name: (image shape, sample range, encoder options, reduction factor,
# Rsiz patch, the format negotiated)
LAYOUTS = {
    "rgb24-rct": ((24, 40, 3), 256, dict(mct=True), 0, False, "rgb24"),
    "rgb24-ict": ((24, 40, 3), 256, dict(mct=True, pred=0), 0, False,
                  "rgb24"),
    "rgb48le-10b": ((24, 40, 3), 1024, dict(depth=10, mct=True), 0, False,
                    "rgb48le"),
    "gray": ((24, 40), 256, {}, 0, False, "gray"),
    "gray16le-12b": ((24, 40), 4096, dict(depth=12), 0, False, "gray16le"),
    "ya8": ((24, 40, 2), 256, {}, 0, False, "ya8"),
    "yuv420p": ([(24, 40), (12, 20), (12, 20)], 256,
                dict(chroma_shift=(1, 1)), 0, False, "yuv420p"),
    "xyz12le-dci": ((24, 40, 3), 4096, dict(depth=12, mct=True), 0, True,
                    "xyz12le"),
    "rgb48le-tiles-offset": ((37, 45, 3), 1024,
                             dict(depth=10, mct=True, tile_width=16,
                                  tile_height=16, origin=(5, 3)), 0, False,
                             "rgb48le"),
    # odd offset: the chroma planes have a column no tile writes (zero)
    "yuv420p-tiles-offset": ([(23, 41), (12, 21), (12, 21)], 256,
                             dict(chroma_shift=(1, 1), origin=(1, 1),
                                  tile_width=16, tile_height=16), 0, False,
                             "yuv420p"),
    "rgb48le-lowres": ((24, 40, 3), 1024, dict(depth=10, mct=True), 1,
                       False, "rgb48le"),
    "yuv420p-lowres": ([(24, 40), (12, 20), (12, 20)], 256,
                       dict(chroma_shift=(1, 1)), 1, False, "yuv420p"),
}


def _layout_streams(name, frames=2):
    shape, hi, enc, red, dci, _fmt = LAYOUTS[name]
    streams = [port_encoder.encode_frame_htj2k(_img(seed, shape, hi),
                                               **TINY, **enc)
               for seed in range(frames)]
    return [_dci(d) for d in streams] if dci else streams


@pytest.mark.parametrize("entry", ["decode", "decode_stream",
                                   "decode_batch"])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_frame_layout_matches_the_jax_package(name, entry):
    """The program writes the negotiated format's frame (interleaved,
    shifted to the output precision, each tile at its place) and the
    host copies its planes out: every plane equals the JAX package's
    host decoder's, which its suite holds equal to its ``Decoder`` (a
    JAX ``Decoder`` compiles a program per geometry, tens of seconds
    on the CPU), and every frame counts ``device_layout_frames``."""
    streams = _layout_streams(name)
    red = LAYOUTS[name][3]
    dec = Decoder(device="cpu", reduction_factor=red)
    c0 = trace.counters.get("device_layout_frames", 0)
    if entry == "decode":
        got = [dec.decode(d) for d in streams]
    elif entry == "decode_stream":
        got = list(dec.decode_stream(streams, depth=2))
    else:
        got = dec.decode_batch(streams)
    assert trace.counters["device_layout_frames"] - c0 == len(streams)
    assert dec.v3_frames + dec.v2_frames == len(streams)
    for g, d in zip(got, streams):
        want = jax_host.decode_frame(d, bitexact=True, reduction_factor=red)
        assert g.fmt.name == want.fmt.name == LAYOUTS[name][5]
        assert (g.width, g.height) == (want.width, want.height)
        assert len(g.planes) == len(want.planes)
        for a, b in zip(g.planes, want.planes):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b)


def test_frame_layout_of_tiles_at_an_offset_matches_the_jax_decoder(
        jax_dec):
    """The interleaved, shifted layout of tiles at an image offset
    through ``decode_batch`` against the JAX ``Decoder``'s device
    program itself (one geometry: a compile of ~10 s on the CPU)."""
    streams = _layout_streams("rgb48le-tiles-offset")
    got = Decoder(device="cpu").decode_batch(streams)
    want = jax_dec.decode_batch(streams)
    assert [g.fmt.name for g in got] == [w.fmt.name for w in want] \
        == ["rgb48le"] * 2
    for g, w in zip(got, want):
        assert len(g.planes) == len(w.planes) == 1
        assert g.planes[0].dtype == w.planes[0].dtype
        assert np.array_equal(g.planes[0], w.planes[0])


def _dci_mix(n):
    """`n` 12-bit RGB streams of one geometry (ramps with a little noise,
    so that every frame takes the same guard bits), the first half with
    Rsiz 4 (xyz12le), the rest with 0x4000 (rgb48le)."""
    shape, _hi, enc, *_rest = LAYOUTS["xyz12le-dci"]
    ramp = np.add.outer(np.arange(24) * 40, np.arange(40) * 50)[:, :, None] \
        + np.array([0, 300, 600])
    streams = [port_encoder.encode_frame_htj2k(
        (ramp + _img(seed, shape, 64)).astype(np.uint16), **TINY, **enc)
        for seed in range(n)]
    return [_dci(d) for d in streams[:n // 2]] + streams[n // 2:]


@pytest.mark.parametrize("shards", [None, 2, 4])
def test_a_batch_of_two_formats_decodes_each_frame_in_its_own(shards):
    """xyz12le and rgb48le frames of one geometry in one batch share no
    frame layout: the program writes the identity layout and each frame
    is written by its own header, on one device and over 2 shards (each
    shard's frames agree among themselves) or 4 (one frame each). The
    split takes the layout from the program's output, never from the
    shard's own headers."""
    streams = _dci_mix(4)
    hdrs = [port_parse(d) for d in streams]
    fg = port_fp.FlatGeometry(hdrs[0])
    assert frame_layout(hdrs, fg.geom) == FrameLayout.identity(fg.geom.key())
    dec = Decoder(device="cpu")
    got = dec.decode_batch(streams, require_shard=shards is not None,
                           devices=None if shards is None
                           else ["cpu"] * shards)
    assert dec.v3_frames == 4
    assert [g.fmt.name for g in got] == ["xyz12le"] * 2 + ["rgb48le"] * 2
    for g, d in zip(got, streams):
        want = jax_host.decode_frame(d, bitexact=True)
        assert g.fmt.name == want.fmt.name
        assert np.array_equal(g.planes[0], want.planes[0])


def _layout_of(name):
    hdr = port_parse(_layout_streams(name, 1)[0],
                     reduction_factor=LAYOUTS[name][3])
    fg = port_fp.FlatGeometry(hdr)
    return hdr, fg, frame_layout([hdr], fg.geom)


@pytest.mark.parametrize("name,kind", [
    ("rgb48le-tiles-offset", "rct"), ("rgb24-ict", "ict"),
    ("yuv420p-tiles-offset", "plane"), ("ya8", "plane"),
    ("gray16le-12b", "plane")])
def test_writeframe_refs_in_a_layout_equal_write_frame_prescaled(name,
                                                                 kind):
    """The plain write versions, each tile-component plane at its dest of
    the frame layout, give the frame that ``_write_frame_prescaled``
    writes from the same clipped planes (the host write before the
    layout, which the identity layout's route keeps)."""
    hdr, fg, layout = _layout_of(name)
    geom, siz = fg.geom, hdr.siz
    rng = np.random.default_rng(3)
    lo, hi = -(1 << geom.cbps), 1 << geom.cbps  # past the clip both ways
    ys = [torch.from_numpy(rng.integers(lo, hi, (ph, pw)).astype(np.int32))
          for _o, ph, pw in geom.planes]
    out = torch.full((layout.frame_size,), 0,
                     dtype=torch.int16 if layout.wide else torch.uint8)
    clipped = {}
    for idxs in geom.tile_comp_index:
        y = [ys[i] for i in idxs]
        dests = [layout.dests[i] for i in idxs]
        if kind == "rct":
            mct_cuda.rct_writeframe_ref(*y[:3], geom.cbps, out, dests[:3])
            c = mct_cuda.rct_writeframe_ref(*y[:3], geom.cbps)
        elif kind == "ict":
            mct_cuda.ict_writeframe_ref(*y[:3], geom.cbps, DWT97_INT, out,
                                        dests[:3])
            c = mct_cuda.ict_writeframe_ref(*y[:3], geom.cbps, DWT97_INT)
        else:
            mct_cuda.plane_writeframe_ref(y, geom.cbps, out, dests)
            c = [mct_cuda.dc_shift_clip(p, geom.cbps) for p in y]
        clipped.update(zip(idxs, c))
    fmt = pixfmt.negotiate(siz, hdr.colour_space, siz.rsiz)
    want = pixfmt.alloc_frame(fmt, layout.width, layout.height)
    for tile, idxs in zip(fg.tiles, geom.tile_comp_index):
        port_decoder._write_frame_prescaled(
            hdr, tile, [clipped[i].numpy().astype(np.int64) for i in idxs],
            fmt, want, pixfmt.output_precision(fmt, siz.precision),
            port_decoder._cdef(hdr))
    buf = out.numpy().view(np.uint16) if layout.wide else out.numpy()
    assert layout.zero == (name == "yuv420p-tiles-offset")
    for (o, h, w), plane in zip(layout.planes, want):
        assert np.array_equal(buf[o:o + h * w].reshape(h, w), plane)


def test_identity_layout_is_the_tile_component_planes_back_to_back():
    """The identity layout is the tile-component planes back to back,
    unshifted (the layout the wire pack and the programs' tests take),
    and the write versions' default dests are that layout. A program in
    it writes one geometry's samples and the flag; it is the layout the
    decoder picks for the wire pack."""
    hdr, fg, layout = _layout_of("rgb48le-10b")
    geom = fg.geom
    ident = FrameLayout.identity(geom.key())
    assert ident.dests == tuple((o, w, 1, 0) for o, _h, w in geom.planes)
    assert ident.fmt is None and layout.fmt.name == "rgb48le"
    assert layout.dests[1] == (1, 3 * 40, 3, 6)   # G: interleaved, << 6
    assert Decoder(device="cpu", wire_pack=True)._layout([hdr], geom) \
        == FrameLayout.identity(geom.key(), wire_pack=True)
    plan = build_plan(fg)
    prog = V3Program(plan, geom.key(), qw=plan.bw // 2, qh=plan.bh // 2,
                     ms_class=8, n_pad=fg.ncblks, frames=1, layout=ident)
    cols = port_fp.parse_frame_flat(hdr, fg)
    args, _ = port_fp.finish_v3(fg, [port_fp.build_v3_frame(fg, cols)],
                                geom.total, "cpu")
    assert prog(**args).numel() == geom.total + 1
    y = [torch.arange(12, dtype=torch.int32).reshape(3, 4) - 6 * k
         for k in range(3)]
    out = torch.zeros(36, dtype=torch.int16)
    mct_cuda.rct_writeframe_ref(*y, 10, out, mct_cuda.back_to_back((3, 4)))
    want = torch.cat([mct_cuda.narrow(c, torch.int16).reshape(-1)
                      for c in mct_cuda.rct_writeframe_ref(*y, 10)])
    assert torch.equal(out, want)


def test_split_frames_copies_each_plane_out_of_the_buffer(dec):
    """No plane ``_split_frames`` returns shares memory with the fetched
    buffer, and the frames stay whole after the buffer is overwritten."""
    streams = _layout_streams("rgb48le-tiles-offset", 1) * 3
    hdrs = [port_parse(d) for d in streams]
    fg = dec._fast_geom(hdrs[0])
    layout = frame_layout(hdrs, fg.geom)
    prog, args = dec._v3_program(
        fg, [port_fp.parse_frame_flat(h, fg) for h in hdrs], layout)
    packed = prog(**args)
    assert packed.numel() == 3 * layout.frame_size + 1
    frames = dec._split_frames([(h, fg.tiles) for h in hdrs], fg.geom,
                               (packed, layout))
    before = [f.tobytes() for f in frames]
    assert before == [dec.decode(d).tobytes() for d in streams]
    buf = packed.numpy()
    assert not any(np.shares_memory(p, buf) for f in frames
                   for p in f.planes)
    packed[:-1] = 0
    assert [f.tobytes() for f in frames] == before
