"""The flat-DWT fallback through the port's whole decode path on the CPU.

A 96x128 stream with 32x32 codeblocks and ``nreslevels=6`` has its lowest
DWT level at 8x6, so ``V3Program`` composes whole planes and runs
``dwt_decode_flat`` instead of the band-direct lifting. The reversible
5/3 + RCT stream must return its source; the integer 9/7 + ICT stream the
bytes of the JAX package's host decoder with ``bitexact=True`` (which its
suite holds byte for byte to its ``Decoder()``). Both must equal the
port's host oracle and go through the device program. This file compiles
no JAX program.
"""

import numpy as np
import pytest

from ffmpeg_ht_tpu.models import host_decoder as jax_host
from ffmpeg_ht_tpu.models.encoder import encode_frame_htj2k
from ffmpeg_ht_tpu_torch.codestream.parser import parse_codestream
from ffmpeg_ht_tpu_torch.models import host_decoder
from ffmpeg_ht_tpu_torch.models.decoder import Decoder
from tests.test_torch_decoder97 import RGB, _decode_v3, _ints

FLAT = dict(nreslevels=6, log2_cblk_width=5, log2_cblk_height=5)
FLAT_STREAMS = {
    "flat_53_rct": encode_frame_htj2k(RGB[0], mct=True, **FLAT),
    "flat_97_ict": encode_frame_htj2k(RGB[0], pred=0, mct=True, **FLAT),
}


@pytest.fixture(scope="module")
def dec_int():
    return Decoder(device="cpu", bitexact=True)


@pytest.mark.parametrize("name", ["flat_53_rct", "flat_97_ict"])
def test_flat_dwt_fallback(name, dec_int):
    data = FLAT_STREAMS[name]
    got = _decode_v3(dec_int, data)
    fg = dec_int._fast_geom(parse_codestream(data, bitexact=True))
    assert [p.band_direct for p in fg.v3_progs.values()] == [False]
    assert np.array_equal(got, _ints(host_decoder.decode_frame(
        data, bitexact=True)))
    if name == "flat_53_rct":              # lossless: the source itself
        assert np.array_equal(got, RGB[0].reshape(-1))
    else:
        assert np.array_equal(got, _ints(jax_host.decode_frame(
            data, bitexact=True)))
