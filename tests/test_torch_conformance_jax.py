"""The JAX ``Decoder`` against the port on two conformance streams.

``ffmpeg_ht_tpu``'s ``Decoder().decode`` must return the bytes of
``ffmpeg_ht_tpu_torch``'s ``Decoder(device="cpu").decode`` on the
corpus's PPT+POC+layers stream (both on the v2 bucketed path) and its
signed 10-bit stream (both on the v3 program). These two read the JAX
program itself; every other corpus stream is held against the JAX host
decoder (tests/test_torch_conformance.py). Each compiles a JAX program
geometry (~97 s cold for the v2 one, ~34 s for the v3 one on an 8-core
CPU host with six test workers), so they sit in a file of their own that
xdist puts beside the other conformance files.
"""

import dataclasses

import pytest

from ffmpeg_ht_tpu.models.decoder import Decoder as JaxDecoder
from ffmpeg_ht_tpu_torch.models.decoder import Decoder
from test_torch_conformance import BY_NAME, ROUTES, encode


@pytest.mark.parametrize("name", ["ppt-poc-layers", "signed-10bit"])
def test_jax_decoder_equals_the_port(name):
    case = BY_NAME[name]
    data = encode(case)
    jax_dec = JaxDecoder()
    want = jax_dec.decode(data)
    dec = Decoder(device="cpu")
    got = dec.decode(data)
    assert (dec.v3_frames, dec.v2_frames, dec.host_frames) == \
        ROUTES[case.route]
    assert dataclasses.astuple(got.fmt) == dataclasses.astuple(want.fmt)
    assert got.tobytes() == want.tobytes()
