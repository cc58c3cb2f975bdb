"""The port's slice end to end on the CPU vs the JAX package.

``ffmpeg_ht_tpu_torch.models.decoder.Decoder(device="cpu")`` must return
the same bytes as ``ffmpeg_ht_tpu``'s ``Decoder`` and the source image in
the negotiated pixel format, for v3-eligible streams (96x128,
nreslevels=3, 32x32 codeblocks: every DWT level takes the band-direct
path). Also pinned: the port's ``finish_v3`` arrays (5/3, integer and
float 9/7), the prefill scatter with its trash slot against the JAX
program, the routing of streams outside the slice, and that the port
imports neither ``jax`` nor the JAX package. The 9/7 path, the flat-DWT
fallback and the batch entry points: tests/test_torch_decoder97.py.
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
from ffmpeg_ht_tpu.models.decoder import Decoder as JaxDecoder
from ffmpeg_ht_tpu.models.encoder import encode_frame_htj2k, encode_frame_t800
from ffmpeg_ht_tpu.ops.dwt import DWT97_INT
from ffmpeg_ht_tpu_torch.codestream.parser import parse_codestream as \
    port_parse
from ffmpeg_ht_tpu_torch.models import fastpath as port_fp
from ffmpeg_ht_tpu_torch.models.assembly import V3Program, build_plan
from ffmpeg_ht_tpu_torch.models.decoder import Decoder
from ffmpeg_ht_tpu_torch.ops import ht_scan, mct_cuda
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
def test_decoder_matches_jax_and_source(name, dec, jax_dec):
    data = STREAMS[name]
    v3_before = dec.v3_frames
    launches = (ht_scan.ht_vlc_pass.launches, ht_scan.ht_magsgn_pass.launches,
                mct_cuda.rct_writeframe.launches)
    got = dec.decode(data)
    assert dec.v3_frames == v3_before + 1 and dec.host_frames == 0
    assert launches == (ht_scan.ht_vlc_pass.launches,
                        ht_scan.ht_magsgn_pass.launches,
                        mct_cuda.rct_writeframe.launches)
    want = jax_dec.decode(data)
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
    prog = fg.v3_progs[(1, _ms_class(fc), True, False)]
    packed = prog(**args)
    assert packed[-1] == 0
    with pytest.raises(InvalidData):
        dec._finish(hdr, fg.tiles, fg.geom, packed)


def test_outside_slice_raises_not_host(dec, jax_dec):
    """A stream with refinement passes leaves the v3 lane: it decodes on
    the device through the v2 bucketed path (never on the host oracle),
    equal to the JAX Decoder and to the source."""
    img = IMAGES["gray8"][0]
    data = encode_frame_htj2k(img, refinement=True, ht_layers=2, **ENC)
    counts = (dec.v2_frames, dec.v3_frames, dec.host_frames)
    got = dec.decode(data)
    assert (dec.v2_frames, dec.v3_frames, dec.host_frames) == (
        counts[0] + 1, counts[1], counts[2])
    assert got.tobytes() == jax_dec.decode(data).tobytes() == img.tobytes()


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
