"""The port's multi-device ``decode_batch(devices=...)`` on the CPU.

Counterpart of tests/test_multichip.py (its four checks that are not
slow, seeded as there): ``Decoder(device="cpu").decode_batch(streams,
devices=["cpu"] * D, require_shard=True)`` shards the frame axis into D
V3Programs of F/D frames each. The sharded output must equal the source,
the port's single-device batch and the JAX package's host decoder byte
for byte (the JAX suite holds its own sharded ``decode_batch`` of the
same streams to the source, tests/test_multichip.py); an unshardable
batch raises ``UnshardableBatch`` with the JAX decoder's message
(reasons checked before any JAX program is compiled, so this file
compiles none), or, without ``require_shard``, logs "cannot shard" and
decodes on one device. Also: frame padding (F not a multiple of D, pad
frames dropped), RGB RCT, the wire pack over D=3, one ms_class for every
shard, and that a CUDA device without a card raises.
"""

import logging

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from ffmpeg_ht_tpu.models import host_decoder as jax_host
from ffmpeg_ht_tpu.models.decoder import Decoder as JaxDecoder
from ffmpeg_ht_tpu.models.encoder import encode_frame_htj2k
from ffmpeg_ht_tpu.utils.errors import UnshardableBatch as JaxUnshardable
from ffmpeg_ht_tpu_torch.models import assembly as ASM
from ffmpeg_ht_tpu_torch.models.decoder import Decoder
from ffmpeg_ht_tpu_torch.utils.errors import UnshardableBatch

RNG = np.random.default_rng(31337)


def _mesh(n):
    from jax.sharding import Mesh
    devs = [d for d in jax.devices() if d.platform == "cpu"]
    if len(devs) < n:
        pytest.skip(f"need {n} cpu devices")
    return Mesh(np.array(devs[:n]), axis_names=("frames",))


def test_decode_batch_sharded_bit_identical():
    imgs = [RNG.integers(0, 256, (64, 80), dtype=np.uint8)
            for _ in range(8)]
    streams = [encode_frame_htj2k(im) for im in imgs]
    dec = Decoder(device="cpu")
    sharded = dec.decode_batch(streams, devices=["cpu"] * 4,
                               require_shard=True)
    assert dec.v3_frames == 8
    single = dec.decode_batch(streams)
    want = [jax_host.decode_frame(d, bitexact=True) for d in streams]
    assert len(sharded) == len(want) == 8
    for i, (a, b, c, im) in enumerate(zip(sharded, single, want, imgs)):
        assert a.tobytes() == im.tobytes(), f"frame {i} wrong pixels"
        assert a.tobytes() == b.tobytes(), f"frame {i} != single-device"
        assert a.tobytes() == c.tobytes(), f"frame {i} != JAX host"


def test_decode_batch_sharded_frame_padding():
    """F = 5 over D = 4: the frame axis pads to 8 by repeating the last
    frame (the last shard holds pads only) and exactly 5 frames come
    back; ``v3_frames`` counts the real ones."""
    imgs = [RNG.integers(0, 256, (64, 80), dtype=np.uint8)
            for _ in range(5)]
    streams = [encode_frame_htj2k(im) for im in imgs]
    dec = Decoder(device="cpu")
    sharded = dec.decode_batch(streams, devices=["cpu"] * 4,
                               require_shard=True)
    assert len(sharded) == 5 and dec.v3_frames == 5
    for i, (a, im) in enumerate(zip(sharded, imgs)):
        assert a.tobytes() == im.tobytes(), f"frame {i} wrong pixels"


def test_decode_batch_unshardable_raises_and_warns(caplog):
    """HT MIXED streams leave the fast-lane profile: the port raises the
    JAX decoder's message with require_shard=True, and without it logs a
    warning and still decodes correctly on one device."""
    img = RNG.integers(0, 256, (40, 48), dtype=np.uint8)
    streams = [encode_frame_htj2k(img, ht_mixed=True) for _ in range(2)]
    with pytest.raises(JaxUnshardable) as want:
        JaxDecoder(bitexact=True).decode_batch(streams, mesh=_mesh(2),
                                               require_shard=True)
    dec = Decoder(device="cpu")
    with pytest.raises(UnshardableBatch, match="profile") as got:
        dec.decode_batch(streams, devices=["cpu"] * 2, require_shard=True)
    assert str(got.value) == str(want.value)
    with caplog.at_level(logging.WARNING, logger="ffmpeg_ht_tpu_torch"):
        frames = dec.decode_batch(streams, devices=["cpu"] * 2)
    assert any("cannot shard" in r.message for r in caplog.records)
    assert all(f.tobytes() == img.tobytes() for f in frames)


def _reason_case(name):
    """(decoder options, streams) of a batch that cannot shard."""
    r = np.random.default_rng(4711)
    img = r.integers(0, 256, (64, 80), dtype=np.uint8)
    enc = dict(nreslevels=3, log2_cblk_width=5, log2_cblk_height=5)
    if name == "empty":
        return {}, []
    if name == "max_layers":
        return dict(max_layers=1), [encode_frame_htj2k(img)] * 2
    if name == "two_geometries":
        return {}, [encode_frame_htj2k(img), encode_frame_htj2k(img[:48])]
    # refinement lanes need the v2 path: no v3 frame for the stream
    return {}, [encode_frame_htj2k(img, **enc),
                encode_frame_htj2k(img, refinement=True, ht_layers=2,
                                   **enc)]


@pytest.mark.parametrize("name", ["empty", "max_layers", "two_geometries",
                                  "refined"])
def test_unshardable_reason_matches_jax(name):
    """Each reason is the JAX decoder's string, found before any program
    is built on either side."""
    opts, streams = _reason_case(name)
    with pytest.raises(JaxUnshardable) as want:
        JaxDecoder(bitexact=True, **opts).decode_batch(
            streams, mesh=_mesh(2), require_shard=True)
    with pytest.raises(UnshardableBatch) as got:
        Decoder(device="cpu", **opts).decode_batch(
            streams, devices=["cpu", "cpu"], require_shard=True)
    assert str(got.value) == str(want.value)


def test_decode_batch_sharded_rgb():
    imgs = [RNG.integers(0, 256, (48, 56, 3), dtype=np.uint8)
            for _ in range(4)]
    streams = [encode_frame_htj2k(im, mct=True) for im in imgs]
    dec = Decoder(device="cpu")
    sharded = dec.decode_batch(streams, devices=["cpu"] * 2,
                               require_shard=True)
    single = [dec.decode(s) for s in streams]
    for a, b, im in zip(sharded, single, imgs):
        assert a.tobytes() == im.tobytes()
        assert a.tobytes() == b.tobytes()


def test_decode_batch_sharded_wire_pack_pads():
    """10-bit frames with the wire pack, F = 4 over D = 3 (two pad
    frames, one shard of pads only): each shard packs its own words, and
    the frames equal the unpacked single-device batch and the source."""
    imgs = [RNG.integers(0, 1024, (64, 80), dtype=np.uint16)
            for _ in range(4)]
    streams = [encode_frame_htj2k(im, depth=10) for im in imgs]
    packed = Decoder(device="cpu", wire_pack=True).decode_batch(
        streams, devices=["cpu"] * 3, require_shard=True)
    plain = Decoder(device="cpu").decode_batch(streams)
    assert len(packed) == 4
    for a, b, im in zip(packed, plain, imgs):
        assert a.tobytes() == b.tobytes()
        assert a.tobytes() == (im << 6).tobytes()


def test_each_shard_runs_its_own_program(monkeypatch):
    """D = 3 shards of F = 7 frames (two pads): three V3Program calls of
    three frames each, on the listed devices, all at the batch's one
    ms_class, with lane arguments for their own frames only."""
    imgs = [RNG.integers(0, 256, (64, 80), dtype=np.uint8)
            for _ in range(6)]
    # a flat mid-grey frame codes no codeblock: its own class is the least
    imgs.append(np.full((64, 80), 128, np.uint8))
    streams = [encode_frame_htj2k(im) for im in imgs]
    calls = []
    orig = ASM.V3Program.__call__

    def spy(self, **args):
        calls.append((self.frames, self.ms_class, args["msw"].shape[0],
                      args["msw"].device.type))
        return orig(self, **args)

    monkeypatch.setattr(ASM.V3Program, "__call__", spy)
    dec = Decoder(device="cpu")
    out = dec.decode_batch(streams, devices=["cpu"] * 3, require_shard=True)
    assert [f.tobytes() for f in out] == [im.tobytes() for im in imgs]
    fg = next(iter(dec._geoms.values()))
    assert len(calls) == 3
    batch_class = calls[0][1]
    assert {c[:2] for c in calls} == {(3, batch_class)}
    assert all(c[2] == 3 * fg.ncblks and c[3] == "cpu" for c in calls)
    # the last shard holds the flat frame and its pads only: a program
    # of its own frames would take a smaller class
    calls.clear()
    single = dec.decode_batch(streams[-1:], devices=["cpu"])
    assert single[0].tobytes() == imgs[-1].tobytes()
    assert len(calls) == 1 and calls[0][1] < batch_class


def test_devices_are_resolved_first():
    """A CUDA entry without a card raises before anything decodes; an
    empty list or a bare device name is refused."""
    img = RNG.integers(0, 256, (64, 80), dtype=np.uint8)
    streams = [encode_frame_htj2k(img)] * 2
    dec = Decoder(device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        dec.decode_batch(streams, devices=["cuda"])
    with pytest.raises(RuntimeError, match="is_available"):
        dec.decode_batch(streams, devices=["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="empty"):
        dec.decode_batch(streams, devices=[])
    with pytest.raises(TypeError):
        dec.decode_batch(streams, devices="cpu")
    assert dec.v3_frames == 0
