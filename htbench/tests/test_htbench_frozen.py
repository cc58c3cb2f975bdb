"""The frozen encoder, the benchmark's traffic generator, makes the same
bytes as when the benchmark was defined, and the port decodes them
losslessly."""

import hashlib

import numpy as np
import pytest

from htbench.frozen.models.encoder import encode_frame_htj2k

ENC_C3 = dict(depth=10, tile_width=4096, tile_height=4096,
              log2_cblk_width=6, log2_cblk_height=6, nreslevels=7, mct=True)
PINNED = "30c3c41a86dd24970a0a9f614aaede83a6069c5335a23a2217ca29f4bd2a1ff3"
PINNED_LOSSY = "c4c98cf8966a9a2b06a0325624f5df6e7fb2e683b51ae42ee26949947fac56f3"


def _source():
    rng = np.random.default_rng(20261017)
    base = rng.integers(0, 1024, (48, 80), dtype=np.uint16)
    return np.stack([base, np.roll(base, 5, 1), np.roll(base, 9, 0)], 2)


def test_frozen_encoder_stream_is_pinned():
    data = encode_frame_htj2k(_source(), **ENC_C3)
    assert hashlib.sha256(data).hexdigest() == PINNED


def test_frozen_lossy_stream_is_pinned():
    """The 9/7 + ICT path, with SOP, EPH and the RPCL order, for the
    lossy cells to come."""
    src = (_source() >> 2).astype(np.uint8)
    data = encode_frame_htj2k(src, pred=0, mct=True, nreslevels=6, sop=True,
                              eph=True, prog="rpcl")
    assert hashlib.sha256(data).hexdigest() == PINNED_LOSSY


def test_options_left_out_of_the_copy_are_refused():
    with pytest.raises(TypeError):
        encode_frame_htj2k(_source(), refinement=True, **ENC_C3)
    with pytest.raises(TypeError):
        encode_frame_htj2k(_source(), ht_layers=2, **ENC_C3)


def test_frozen_stream_decodes_losslessly_through_the_port():
    from ffmpeg_ht_tpu_torch.models.decoder import Decoder
    src = _source()
    frame = Decoder(device="cpu").decode(encode_frame_htj2k(src, **ENC_C3))
    want = src.astype(np.uint16) << 6
    assert frame.planes[0].reshape(want.shape).tolist() == want.tolist()
