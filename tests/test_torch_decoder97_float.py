"""The port's float 9/7 path (``bitexact=False``: float 9/7, float ICT,
rint) on the CPU: within 1 LSB of the JAX ``Decoder(bitexact=False)`` and
of the port's host float oracle (the bar of
tests/test_tpu_decoder.py:111-126). The streams and helpers are those of
tests/test_torch_decoder97.py; this file compiles one JAX geometry, the
float ICT stream.
"""

import numpy as np
import pytest

from ffmpeg_ht_tpu.models.decoder import Decoder as JaxDecoder
from ffmpeg_ht_tpu_torch.models import host_decoder
from ffmpeg_ht_tpu_torch.models.decoder import Decoder
from tests.test_torch_decoder97 import STREAMS, _decode_v3, _ints


@pytest.fixture(scope="module")
def dec_float():
    return Decoder(device="cpu", bitexact=False)


@pytest.mark.parametrize("name", ["gray8", "rgb8_ict"])
def test_decoder_97float_within_1lsb(name, dec_float):
    data = STREAMS[name]
    got = _decode_v3(dec_float, data)
    host = _ints(host_decoder.decode_frame(data, bitexact=False))
    assert np.abs(got - host).max() <= 1
    if name == "rgb8_ict":                 # float DWT + float ICT + rint
        want = _ints(JaxDecoder(bitexact=False).decode(data))
        assert np.abs(got - want).max() <= 1
