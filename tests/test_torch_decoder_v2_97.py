"""The v2 bucketed path for a refined irreversible stream, on the CPU vs
the JAX package.

An RGB 8-bit 9/7 + ICT stream with SigProp / MagRef passes (64x64, 2
resolution levels, 32x32 codeblocks: one bucket shape, so that the JAX
side compiles few kernels; kept in its own file so that they compile on
their own xdist worker). ``Decoder(device="cpu", bitexact=True)`` of the
port must be byte-identical to the JAX package's integer host decoder
(which its suite holds byte for byte to its ``Decoder()``) and to the
port's; ``bitexact=False`` within 1 LSB of the JAX
``Decoder(bitexact=False)``, the one JAX program this file compiles, and
of the port's float host oracle.
"""

import numpy as np
import pytest

from ffmpeg_ht_tpu.models import host_decoder as jax_host
from ffmpeg_ht_tpu.models.decoder import Decoder as JaxDecoder
from ffmpeg_ht_tpu_torch.models import host_decoder as port_host
from ffmpeg_ht_tpu_torch.models.decoder import Decoder
from ffmpeg_ht_tpu_torch.models.encoder import encode_frame_htj2k

RGB8 = np.random.default_rng(20261019).integers(0, 256, (64, 64, 3),
                                                dtype=np.uint8)
ICT = encode_frame_htj2k(RGB8, pred=0, mct=True, refinement=True,
                         ht_layers=2, nreslevels=2, log2_cblk_width=5,
                         log2_cblk_height=5)


def _samples(frame):
    return np.frombuffer(frame.tobytes(), np.uint8).astype(np.int64)


@pytest.mark.parametrize("bitexact", [True, False])
def test_v2_ict_matches_jax_and_host_oracle(bitexact):
    dec = Decoder(device="cpu", bitexact=bitexact)
    got = dec.decode(ICT)
    assert (dec.v2_frames, dec.v3_frames, dec.host_frames) == (1, 0, 0)
    want = jax_host.decode_frame(ICT, bitexact=True) if bitexact \
        else JaxDecoder(bitexact=False).decode(ICT)
    host = port_host.decode_frame(ICT, bitexact=bitexact)
    assert got.fmt.name == want.fmt.name == host.fmt.name == "rgb24"
    if bitexact:
        assert got.tobytes() == want.tobytes() == host.tobytes()
    else:
        for other in (want, host):
            assert np.abs(_samples(got) - _samples(other)).max() <= 1
    # lossy, but close to the source
    assert np.abs(_samples(got) - RGB8.reshape(-1).astype(np.int64)).mean() \
        < 8
