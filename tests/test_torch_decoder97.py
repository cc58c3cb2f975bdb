"""The port's irreversible 9/7 path and batch entry points on the CPU vs
the JAX package.

``Decoder(device="cpu", bitexact=True)`` (integer 9/7, integer ICT) must
return the bytes of the JAX package's host decoder with ``bitexact=True``
(which its suite holds byte for byte to its ``Decoder()``,
tests/test_tpu_decoder.py) and of the port's host oracle. Streams are
96x128 with 32x32 codeblocks and ``nreslevels=3``, which keeps every DWT
level at least 8x8 (band-direct). The float path (``bitexact=False``),
the one that compiles a JAX program, is in
tests/test_torch_decoder97_float.py and the flat-DWT fallback in
tests/test_torch_flat_dwt.py. This file compiles no JAX program; the batch
streams are held against the frame-by-frame decode and the host oracle.
"""

import numpy as np
import pytest

from ffmpeg_ht_tpu.models import host_decoder as jax_host
from ffmpeg_ht_tpu.models.encoder import encode_frame_htj2k
from ffmpeg_ht_tpu_torch.codestream.parser import parse_codestream
from ffmpeg_ht_tpu_torch.models import host_decoder
from ffmpeg_ht_tpu_torch.models.decoder import Decoder
from ffmpeg_ht_tpu_torch.ops import ht_scan, mct_cuda

ENC = dict(nreslevels=3, log2_cblk_width=5, log2_cblk_height=5)
RNG = np.random.default_rng(20261017)
GRAY = RNG.integers(0, 256, (96, 128), dtype=np.uint8)
RGB = [RNG.integers(0, 256, (96, 128, 3), dtype=np.uint8) for _ in range(3)]
STREAMS = {
    "gray8": encode_frame_htj2k(GRAY, pred=0, **ENC),
    "rgb8_ict": encode_frame_htj2k(RGB[0], pred=0, mct=True, **ENC),
}


@pytest.fixture(scope="module")
def dec_int():
    return Decoder(device="cpu", bitexact=True)


@pytest.fixture(scope="module")
def dec_float():
    return Decoder(device="cpu", bitexact=False)


def _launches():
    return (ht_scan.ht_vlc_pass.launches, ht_scan.ht_magsgn_pass.launches,
            mct_cuda.rct_writeframe.launches,
            mct_cuda.ict_writeframe.launches)


def _decode_v3(dec, data):
    """Decode through the device program (on the CPU: the plain versions,
    no kernel launch); returns the frame's bytes as ints."""
    before, launches = dec.v3_frames, _launches()
    got = dec.decode(data)
    assert dec.v3_frames == before + 1 and dec.host_frames == 0
    assert _launches() == launches
    return np.frombuffer(got.tobytes(), np.uint8).astype(np.int64)


def _ints(frame):
    return np.frombuffer(frame.tobytes(), np.uint8).astype(np.int64)


@pytest.mark.parametrize("name", ["gray8", "rgb8_ict"])
def test_decoder_97int_matches_jax_and_host(name, dec_int):
    data = STREAMS[name]
    got = _decode_v3(dec_int, data)
    assert np.array_equal(got, _ints(jax_host.decode_frame(
        data, bitexact=True)))
    assert np.array_equal(got, _ints(host_decoder.decode_frame(
        data, bitexact=True)))


def test_decode_batch_runs_one_program(dec_float):
    """Three same-geometry lossy frames of four 64x64 tiles: one 3-frame
    program whose frames equal the frame-by-frame decode and lie within
    1 LSB of the host float oracle; other batches decode stream by
    stream."""
    streams = [encode_frame_htj2k(img, pred=0, mct=True, tile_width=64,
                                  tile_height=64, **ENC) for img in RGB]
    solo = [dec_float.decode(s).tobytes() for s in streams]
    before, launches = dec_float.v3_frames, _launches()
    got = dec_float.decode_batch(streams)
    assert [f.tobytes() for f in got] == solo
    assert dec_float.v3_frames == before + 3 and _launches() == launches
    for f, s in zip(got, streams):
        host = _ints(host_decoder.decode_frame(s, bitexact=False))
        assert np.abs(_ints(f) - host).max() <= 1
    fg = dec_float._fast_geom(parse_codestream(streams[0], bitexact=False))
    assert len(fg.tiles) == 4 and {k[0] for k in fg.v3_progs} == {1, 3}
    mixed = [STREAMS["gray8"], streams[1]]
    assert [f.tobytes() for f in dec_float.decode_batch(mixed)] == \
        [dec_float.decode(s).tobytes() for s in mixed]
    assert dec_float.decode_batch([]) == []


def test_bench_resident_on_cpu(dec_int):
    streams = [encode_frame_htj2k(img, pred=0, mct=True, **ENC)
               for img in RGB]
    res = dec_int.bench_resident(streams, n_it=1, reps=1)
    assert set(res) == {"fps", "ms_per_frame", "frames_merged"}
    assert res["frames_merged"] == 3 and res["fps"] > 0
    assert res["ms_per_frame"] > 0
    with pytest.raises(ValueError):                 # two geometries
        dec_int.bench_resident([STREAMS["gray8"], streams[0]])
    v2 = encode_frame_htj2k(GRAY, refinement=True, ht_layers=2, **ENC)
    with pytest.raises(ValueError):                 # refinement lanes
        dec_int.bench_resident([v2])
