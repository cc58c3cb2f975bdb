"""The v2 bucketed path on the CPU vs the JAX package.

Refined HTONLY streams (SigProp / MagRef passes in a second HT quality
layer) at the port tests' small geometry (96x128, nreslevels=3, 32x32
codeblocks) leave the v3 lane. ``Decoder(device="cpu")`` of the port must
decode them on its device path (``v2_frames``), byte-identical to the JAX
package's host decoder (which its suite holds byte for byte to its
``Decoder``) and to the source: through the flat lane
(``build_bucket_args`` / ``finish_buckets``) for the fast-profile streams,
through the object path (``_build_batch`` / ``_Bucket.pack``) for the
vertically stripe-causal one; ``reduction_factor=1`` with the same option.
The streams are lossless, so no JAX program is compiled. The RGB stream,
``max_layers=1`` and the batches are held against the host oracles and
the sources. The lane arrays, the state the host hands the device, equal
the JAX functions' (``finish_buckets``, ``_bucket_arrays``) field by
field, pad lanes included.
"""

import dataclasses

import numpy as np
import pytest

from ffmpeg_ht_tpu.codestream.geometry import init_tile as jax_init_tile
from ffmpeg_ht_tpu.codestream.parser import parse_codestream as jax_parse
from ffmpeg_ht_tpu.codestream.t2 import decode_tile_packets as jax_t2
from ffmpeg_ht_tpu.models import decoder as jax_decoder
from ffmpeg_ht_tpu.models import fastpath as jax_fp
from ffmpeg_ht_tpu.models import host_decoder as jax_host
from ffmpeg_ht_tpu_torch.codestream.geometry import init_tile
from ffmpeg_ht_tpu_torch.codestream.parser import parse_codestream
from ffmpeg_ht_tpu_torch.codestream.t2 import decode_tile_packets
from ffmpeg_ht_tpu_torch.models import decoder as port_decoder
from ffmpeg_ht_tpu_torch.models import fastpath as port_fp
from ffmpeg_ht_tpu_torch.models import host_decoder as port_host
from ffmpeg_ht_tpu_torch.models.decoder import Decoder
from ffmpeg_ht_tpu_torch.models.encoder import encode_frame_htj2k
from ffmpeg_ht_tpu_torch.ops import ht_refine, ht_scan

ENC = dict(nreslevels=3, log2_cblk_width=5, log2_cblk_height=5)
RNG = np.random.default_rng(20261018)
GRAY = RNG.integers(0, 256, (96, 128), dtype=np.uint8)
GRAY_B = RNG.integers(0, 256, (96, 128), dtype=np.uint8)
RGB10 = RNG.integers(0, 1024, (96, 128, 3), dtype=np.uint16)
STREAMS = {
    "gray8_l2": encode_frame_htj2k(GRAY, refinement=True, ht_layers=2,
                                   **ENC),
    "gray8_l3": encode_frame_htj2k(GRAY, refinement=True, ht_layers=3,
                                   **ENC),
    "vsc": encode_frame_htj2k(GRAY, refinement=True, ht_layers=2,
                              causal=True, **ENC),
}
GRAY_B_L2 = encode_frame_htj2k(GRAY_B, refinement=True, ht_layers=2, **ENC)
GRAY_B_VSC = encode_frame_htj2k(GRAY_B, refinement=True, ht_layers=2,
                                causal=True, **ENC)
RGB10_L2 = encode_frame_htj2k(RGB10, depth=10, mct=True, refinement=True,
                              ht_layers=2, **ENC)
# the right half quieter: shorter streams, so some of its lanes share a
# bucket with fewer lanes than GRAY's
GRAY_HALF = GRAY.copy()
GRAY_HALF[:, 64:] = GRAY_HALF[:, 64:] // 8 + 100
GRAY_HALF_L2 = encode_frame_htj2k(GRAY_HALF, refinement=True, ht_layers=2,
                                  **ENC)


def _counts(dec):
    return dec.v2_frames, dec.v3_frames, dec.host_frames


def _launches():
    return (ht_scan.ht_vlc_pass.launches, ht_scan.ht_magsgn_pass.launches,
            ht_refine.decode_refinement_scan.launches)


@pytest.mark.parametrize("name", list(STREAMS))
def test_v2_decode_matches_jax_and_source(name):
    data = STREAMS[name]
    dec = Decoder(device="cpu")
    before = _launches()
    got = dec.decode(data)
    assert _counts(dec) == (1, 0, 0) and _launches() == before
    # the causal stream leaves the fast profile: the object path
    assert port_fp.fast_profile(parse_codestream(data)) == (name != "vsc")
    want = jax_host.decode_frame(data, bitexact=True)
    assert dataclasses.astuple(got.fmt) == dataclasses.astuple(want.fmt)
    assert got.tobytes() == want.tobytes() == GRAY.tobytes()


def test_v2_rgb10_rct_matches_host_oracle_and_source():
    dec = Decoder(device="cpu")
    got = dec.decode(RGB10_L2)
    assert _counts(dec) == (1, 0, 0)
    assert got.tobytes() == port_host.decode_frame(RGB10_L2,
                                                   bitexact=True).tobytes()
    assert np.array_equal(got.planes[0].reshape(96, 128, 3), RGB10 << 6)


def test_v2_reduction_factor_matches_jax():
    data = STREAMS["gray8_l2"]
    dec = Decoder(device="cpu", reduction_factor=1)
    got = dec.decode(data)
    assert _counts(dec) == (1, 0, 0) and (got.width, got.height) == (64, 48)
    want = jax_host.decode_frame(data, bitexact=True, reduction_factor=1)
    assert got.tobytes() == want.tobytes()
    assert got.tobytes() == port_host.decode_frame(
        data, bitexact=True, reduction_factor=1).tobytes()


def test_v2_max_layers_matches_host_oracles():
    """max_layers=1 keeps the cleanup layer only: the object path, no
    refinement; equal to both packages' host oracles with the same option
    (the JAX package pins its Decoder(max_layers=1) to its oracle,
    tests/test_ht_layers_prec.py), and not to the full decode."""
    data = STREAMS["gray8_l2"]
    dec = Decoder(device="cpu", max_layers=1)
    got = dec.decode(data).tobytes()
    assert _counts(dec) == (1, 0, 0)
    assert got == port_host.decode_frame(data, bitexact=True,
                                         max_layers=1).tobytes()
    assert got == jax_host.decode_frame(data, bitexact=True,
                                        max_layers=1).tobytes()
    assert got != GRAY.tobytes()


@pytest.mark.parametrize("pair", [(STREAMS["gray8_l2"], GRAY_B_L2),
                                  (STREAMS["vsc"], GRAY_B_VSC)],
                         ids=["flat_lane", "object_path"])
def test_v2_decode_batch_is_one_dispatch(pair, monkeypatch):
    """Two frames of one geometry: one BucketProgram over the replicated
    geometry, both frames equal to their sources."""
    calls = []
    orig = port_decoder.BucketProgram.__call__
    monkeypatch.setattr(port_decoder.BucketProgram, "__call__",
                        lambda self, *a: calls.append(self) or orig(self, *a))
    dec = Decoder(device="cpu")
    frames = dec.decode_batch(list(pair))
    assert len(calls) == 1 and calls[0].total == 2 * 96 * 128
    assert _counts(dec) == (2, 0, 0)
    assert [f.tobytes() for f in frames] == [GRAY.tobytes(),
                                            GRAY_B.tobytes()]


def _flat_accum(fp, parse, data_list):
    hdrs = [parse(d, bitexact=True) for d in data_list]
    fg = fp.FlatGeometry(hdrs[0])
    accum = None
    for f, hdr in enumerate(hdrs):
        accum = fp.build_bucket_args(fg, fp.parse_frame_flat(hdr, fg),
                                     dest_shift=f * fg.geom.total,
                                     prev=accum)
    return accum, len(hdrs) * fg.geom.total


def _flat_buckets(fp, parse, data_list):
    return fp.finish_buckets(*_flat_accum(fp, parse, data_list))


def _assert_bucket_args_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if k == "nreal":
            assert got[k] == w
            continue
        w = np.asarray(w)
        assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k


@pytest.mark.parametrize("data,uneven", [
    ([STREAMS["gray8_l2"]], False),
    ([STREAMS["gray8_l3"], GRAY_B_L2], False),
    ([RGB10_L2], False),
    ([STREAMS["gray8_l2"], GRAY_HALF_L2], True)],
    ids=["gray8_l2", "two_frames", "rgb10", "uneven_frames"])
def test_finish_buckets_matches_jax(data, uneven):
    """Every array of every bucket, pad lanes included; `uneven`: a
    bucket holds lanes of two frames, in different numbers, and pads."""
    accum, _total = _flat_accum(port_fp, parse_codestream, data)
    counts = [[len(r[1]) for r in b["rows"]]
              for b in accum["buckets"].values()]
    assert uneven == any(len(set(c)) == 2 and sum(c) % 8 for c in counts)
    got = _flat_buckets(port_fp, parse_codestream, data)
    want = _flat_buckets(jax_fp, jax_parse, data)
    assert got[0] == want[0] and any(s[5] for s in got[0])   # refined
    for g, w in zip(got[1], want[1]):
        _assert_bucket_args_equal(g, w)
    for g, w in zip(got[2:], want[2:]):
        w = np.asarray(w)
        assert g.dtype == w.dtype and np.array_equal(g, w)


def _object_buckets(parse, init, t2, mod, data):
    hdr = parse(data, bitexact=True)
    tiles = []
    for tileno in range(len(hdr.tiles)):
        tiles.append(init(hdr, tileno))
        t2(hdr, tileno, tiles[-1], 0)
    geom, buckets, prefill = mod._build_batch(hdr, tiles)
    pack = (lambda b: b.pack()[1]) if mod is port_decoder else \
        (lambda b: mod._bucket_arrays(b)[0])
    return geom, {k: pack(b) for k, b in buckets.items()}, prefill


def test_bucket_arrays_match_jax():
    """The object path's lanes for the causal stream (``causal`` set on
    every lane), geometry and prefill included."""
    data = STREAMS["vsc"]
    g, b, p = _object_buckets(parse_codestream, init_tile,
                              decode_tile_packets, port_decoder, data)
    gj, bj, pj = _object_buckets(jax_parse, jax_init_tile, jax_t2,
                                 jax_decoder, data)
    assert g.key() == gj.key() and np.array_equal(p, pj)
    assert sorted(b) == sorted(bj)
    causal = [a["causal"][:a["nreal"]] for a in b.values() if "causal" in a]
    assert causal and all(c.all() for c in causal)
    for k in b:
        _assert_bucket_args_equal(b[k], bj[k])


def test_deep_lane_goes_to_the_host_prefill():
    """A lane whose zbp_eff + 1 exceeds 25 (the encoder cannot make one:
    16-bit samples top out near maxbp 19) is decoded on the host into the
    prefill, as the JAX build_bucket_args sends it; the other lanes keep
    their buckets."""
    data = STREAMS["gray8_l2"]

    def run(fp, parse):
        hdr = parse(data, bitexact=True)
        fg = fp.FlatGeometry(hdr)
        cols = dict(fp.parse_frame_flat(hdr, fg))
        act = np.nonzero(cols["active"] & ~fg.area_small)[0]
        cols["zbp"] = cols["zbp"].copy()
        cols["zbp"][act[1]] = 25
        return (fp.finish_buckets(fp.build_bucket_args(fg, cols),
                                  fg.geom.total), fg.geom.total,
                int(fg.w[act[1]] * fg.h[act[1]]))
    (got, total, area), (want, _, _) = run(port_fp, parse_codestream), \
        run(jax_fp, jax_parse)
    assert got[0] == want[0]
    pf_idx, pf_val = got[2], got[3]
    assert len(pf_idx) == area and int(pf_idx.max()) < total
    assert np.array_equal(pf_idx, np.asarray(want[2]))
    assert pf_val.dtype == np.asarray(want[3]).dtype
    assert np.array_equal(pf_val, np.asarray(want[3]))
    for g, w in zip(got[1], want[1]):
        _assert_bucket_args_equal(g, w)
    assert sum(a["nreal"] for a in got[1]) == sum(
        a["nreal"] for a in _flat_buckets(port_fp, parse_codestream,
                                          [data])[1]) - 1
