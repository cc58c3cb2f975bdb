"""The port's wire bit-pack (ops/wirepack.py) vs the JAX package's, and
``Decoder(wire_pack=True)`` on every route of the port, on the CPU.

``pack_words_ref`` must equal the JAX ``pack_words`` (run eagerly on
small arrays) word for word, and both ``unpack_words`` must give the
input back. ``Decoder(device="cpu", wire_pack=True)`` must give the same
bytes as ``wire_pack=False`` on the v3 route, in a 3-frame
``decode_batch``, on the v2 route (``FFMPEG_HT_TPU_V3=0``), on the
object path and on a 12-bit refined stream; at 8 bits the pack is inert
(the checks of tests/test_wirepack.py, at the port's small geometries:
96x128, nreslevels=3, 32x32 codeblocks). No JAX program is compiled.
The kernel itself: tests/test_torch_cuda_kernels.py -k wire_pack.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffmpeg_ht_tpu.ops import wirepack as jax_wp
from ffmpeg_ht_tpu_torch.models import assembly, fastpath
from ffmpeg_ht_tpu_torch.models.decoder import Decoder
from ffmpeg_ht_tpu_torch.models.encoder import encode_frame_htj2k
from ffmpeg_ht_tpu_torch.ops import wirepack as wp

ENC = dict(nreslevels=3, log2_cblk_width=5, log2_cblk_height=5)


# every depth at small ragged n; three depths across the CUDA kernel's
# tile of 256 groups (8192 samples), whose edges the card tests probe
# against this plain version
_REF_CASES = [(n, d) for n in (1, 31, 32, 33, 1000) for d in range(9, 16)] \
    + [(n, d) for n in (8191, 8192, 8193) for d in (9, 10, 15)]


@pytest.mark.parametrize("n,depth", _REF_CASES,
                         ids=[f"{n}-{d}" for n, d in _REF_CASES])
def test_pack_words_ref_matches_jax(depth, n):
    rng = np.random.default_rng(depth * 1000 + n)
    src = rng.integers(0, 1 << depth, (n,), dtype=np.uint16)
    want = np.asarray(jax_wp.pack_words(jnp.asarray(src), depth))
    got = wp.pack_words_ref(torch.from_numpy(src.view(np.int16)), depth)
    assert got.dtype == torch.int32
    assert got.shape == (wp.packed_words_len(n, depth),) == want.shape
    words = got.numpy().view(np.uint32)
    assert np.array_equal(words, want)
    for unpack in (wp.unpack_words, jax_wp.unpack_words):
        assert np.array_equal(unpack(words, depth, n), src)
    assert wp.wire_shape(n, depth) == jax_wp.wire_shape(n, depth)


def test_pack_words_flag_word_and_checks():
    """On a CPU tensor ``pack_words`` takes the plain version; the
    buffer's last element, the program's ok flag, follows the words as
    one word. Depths outside 9..15 are refused."""
    rng = np.random.default_rng(5)
    src = rng.integers(0, 1 << 12, (70,), dtype=np.uint16)
    buf = torch.from_numpy(np.append(src, np.uint16(1)).view(np.int16))
    got = wp.pack_words(buf, 12)
    assert torch.equal(got[:-1], wp.pack_words_ref(buf[:-1], 12))
    assert int(got[-1]) == 1 and got.dtype == torch.int32
    assert got.shape == wp.wire_shape(70, 12)[0]
    for depth in (8, 16):
        with pytest.raises(ValueError):
            wp.pack_words(buf, depth)


@pytest.fixture
def packs(monkeypatch):
    """Counts the device programs' calls of ``pack_words``."""
    calls = []

    def spy(packed, depth):
        calls.append((packed.numel(), depth))
        return wp.pack_words(packed, depth)
    monkeypatch.setattr(assembly, "pack_words", spy)
    return calls


def _streams_10bit(n=1, seed=7):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 1024, (96, 128), dtype=np.uint16)
    imgs = [np.stack([np.roll(base, k, 1)] * 3, axis=2) for k in range(n)]
    return imgs, [encode_frame_htj2k(x, depth=10, mct=True, **ENC)
                  for x in imgs]


def _same_both_ways(streams, route):
    """wire_pack on and off give the same bytes through the same route
    ('v3', 'v2'); returns the packed decoder's frames."""
    plain = Decoder(device="cpu")
    packed = Decoder(device="cpu", wire_pack=True)
    a = [plain.decode(s) for s in streams]
    b = [packed.decode(s) for s in streams]
    assert [x.tobytes() for x in a] == [y.tobytes() for y in b]
    for d in (plain, packed):
        assert getattr(d, f"{route}_frames") == len(streams)
        assert d.host_frames == 0
    return b


def test_decode_wire_pack_matches(packs):
    imgs, streams = _streams_10bit()
    (fr,) = _same_both_ways(streams, "v3")
    assert packs == [(96 * 128 * 3 + 1, 10)]
    assert np.array_equal(fr.planes[0].reshape(imgs[0].shape),
                          imgs[0] << 6)


def test_decode_batch_wire_pack_matches(packs):
    imgs, streams = _streams_10bit(n=3, seed=8)
    plain = Decoder(device="cpu").decode_batch(streams)
    dec = Decoder(device="cpu", wire_pack=True)
    packed = dec.decode_batch(streams)
    assert dec.v3_frames == 3 and packs == [(3 * 96 * 128 * 3 + 1, 10)]
    (fg,) = dec._geoms.values()
    # one packed program: the key's layout holds the pack
    assert [k[-1].wire_pack for k in fg.v3_progs] == [True]
    for a, b, img in zip(plain, packed, imgs):
        assert a.tobytes() == b.tobytes()
        assert np.array_equal(b.planes[0].reshape(img.shape), img << 6)


def test_decode_wire_pack_v2_bucket_path(monkeypatch, packs):
    monkeypatch.setenv("FFMPEG_HT_TPU_V3", "0")
    _imgs, streams = _streams_10bit(seed=9)
    _same_both_ways(streams, "v2")
    # the switch also holds for decode_batch
    dec = Decoder(device="cpu", wire_pack=True)
    dec.decode_batch(streams * 2)
    assert (dec.v2_frames, dec.v3_frames) == (2, 0)
    assert len(packs) == 2 and packs[1][0] == 2 * 96 * 128 * 3 + 1


def test_decode_wire_pack_object_path(monkeypatch, packs):
    monkeypatch.setattr(fastpath, "fast_profile", lambda h: False)
    _imgs, streams = _streams_10bit(seed=10)
    _same_both_ways(streams, "v2")
    assert len(packs) == 1


def test_wire_pack_12bit_refinement(packs):
    rng = np.random.default_rng(11)
    img = rng.integers(0, 1 << 12, (96, 128), dtype=np.uint16)
    data = encode_frame_htj2k(img, depth=12, refinement=True, ht_layers=2,
                              **ENC)
    (fr,) = _same_both_ways([data], "v2")
    assert np.array_equal(fr.planes[0], img << 4)
    assert packs == [(96 * 128 + 1, 12)]


def test_wire_pack_8bit_is_inert(packs):
    rng = np.random.default_rng(12)
    img = rng.integers(0, 256, (96, 128), dtype=np.uint8)
    data = encode_frame_htj2k(img, **ENC)
    d = Decoder(device="cpu", wire_pack=True)
    assert not d._wp(8) and d._wp(10) and not d._wp(16)
    assert d.decode(data).tobytes() == img.tobytes()
    (fg,) = d._geoms.values()
    assert [k[-1].wire_pack for k in fg.v3_progs] == [False] and packs == []
