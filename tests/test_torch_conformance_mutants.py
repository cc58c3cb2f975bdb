"""Bit-flip mutants through the port on the CPU.

For every mutant the port's ``Decoder(device="cpu")`` and the JAX
package's host oracle must give the same pixels, or both raise
``J2KError`` (each package its own class); any other exception fails.
Two seeded streams, a flip each of 64 seeded bits: the 64x64
``np.arange`` stream of tests/test_malformed.py (the v3 program; its
flips begin with that test's 48) and a refined two-layer 96x128 stream
(the v2 program with SigProp / MagRef). ``chip_smoke.py`` phase 10 runs
the same mutants through ``Decoder(device="cuda")``.
"""

import numpy as np
import pytest

from ffmpeg_ht_tpu.models import host_decoder as jax_host
from ffmpeg_ht_tpu.utils.errors import J2KError as JaxJ2KError
from ffmpeg_ht_tpu_torch.models.decoder import Decoder
from ffmpeg_ht_tpu_torch.models.encoder import encode_frame_htj2k
from ffmpeg_ht_tpu_torch.utils.errors import J2KError

FLIPS = 64
# name: (image, encoder options, seed of the flips)
BASES = {
    "arange64": (np.arange(4096, dtype=np.uint8).reshape(64, 64), {}, 7),
    "refined96x128": (np.random.default_rng(20261019).integers(
        0, 256, (96, 128), dtype=np.uint8),
        dict(refinement=True, ht_layers=2), 8),
}
STREAMS = {name: encode_frame_htj2k(img, **enc)
           for name, (img, enc, _seed) in BASES.items()}


def mutants():
    """[(base name, byte position, bit mask)], FLIPS per base."""
    out = []
    for name, (_img, _enc, seed) in BASES.items():
        rng = np.random.default_rng(seed)
        for _ in range(FLIPS):
            pos = int(rng.integers(0, len(STREAMS[name])))
            out.append((name, pos, 1 << int(rng.integers(0, 8))))
    return out


MUTANTS = mutants()


def mutate(name, pos, bit) -> bytes:
    data = bytearray(STREAMS[name])
    data[pos] ^= bit
    return bytes(data)


def _outcome(decode, error):
    try:
        frame = decode()
    except error:
        return ("J2KError",)
    return ("frame", frame.width, frame.height, frame.tobytes())


@pytest.mark.parametrize("name,pos,bit", MUTANTS,
                         ids=[f"{n}-{p}-{b}" for n, p, b in MUTANTS])
def test_mutant_agrees_with_the_host_oracle(name, pos, bit):
    data = mutate(name, pos, bit)
    port = _outcome(lambda: Decoder(device="cpu").decode(data), J2KError)
    ref = _outcome(lambda: jax_host.decode_frame(data, bitexact=True),
                   JaxJ2KError)
    assert port == ref


def test_bases_decode_to_their_sources():
    for name, (img, _enc, _seed) in BASES.items():
        dec = Decoder(device="cpu")
        assert dec.decode(STREAMS[name]).tobytes() == img.tobytes()
        assert (dec.v3_frames, dec.v2_frames) == (
            (1, 0) if name == "arange64" else (0, 1))


def test_chip_smoke_holds_the_same_mutants():
    from test_torch_conformance import _chip_smoke
    smoke = _chip_smoke()
    streams, muts = smoke._mutants()
    assert streams == STREAMS and muts == MUTANTS
