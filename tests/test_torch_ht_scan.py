"""Port cleanup decode (ffmpeg_ht_tpu_torch.ops.ht_scan) vs the JAX kernel.

The same numpy lane arrays go through ``ffmpeg_ht_tpu.ops.ht_scan`` and the
port's ``decode_cleanup_scan_dims``, which takes the plain ``cleanup_ref``
for CPU tensors (the composition of ``vlc_pass_ref`` and
``magsgn_pass_ref``). mu / sig must be bit-identical on every lane whose ok is
true, and ok identical on every lane. The Pallas kernel is reached
through its reference: tests/test_ht_scan_pallas.py pins
``decode_cleanup_pallas`` bit-identical to ``_cleanup_impl``.

Corpora: the mixed-shape, ragged, inert-lane bucket of
tests/test_ht_scan_dims.py and the 12-bit case of
tests/test_ht_scan_pallas.py, rebuilt from the same seeds. Both run the
jitted ``decode_cleanup_scan_dims`` at one shape class (lanes, word
widths, ms_class; ``_shared``), so the JAX kernel compiles once a file.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ffmpeg_ht_tpu.codestream.parser import parse_codestream
from ffmpeg_ht_tpu.models import assembly as ASM
from ffmpeg_ht_tpu.models import fastpath as FP
from ffmpeg_ht_tpu.models.encoder import encode_frame_htj2k
from ffmpeg_ht_tpu.ops.ht_batch import prepare_streams_batch, stream_limits
from ffmpeg_ht_tpu.ops.ht_enc import encode_cleanup
from ffmpeg_ht_tpu.ops.ht_scan import decode_cleanup_scan_dims
from ffmpeg_ht_tpu_torch.codestream.parser import parse_codestream as \
    port_parse
from ffmpeg_ht_tpu_torch.models import fastpath as port_fp
from ffmpeg_ht_tpu_torch.ops import ht_scan as port

KEYS = ("msw", "melw", "vlcw", "pLSB", "maxbp", "ms_lim", "mel_lim", "qws",
        "qhs")


def _tt(a):
    """numpy lane array -> torch CPU tensor (uint32 as int32 bits)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32))
    return torch.from_numpy(a.astype(np.int32))


def _assert_same(jax_out, port_out):
    mu_j, sig_j, ok_j = (np.asarray(x) for x in jax_out)
    mu_p, sig_p, ok_p = port_out
    assert mu_p.dtype == torch.int32 and sig_p.dtype == torch.int32
    assert np.array_equal(ok_j, ok_p.numpy())
    good = ok_j.astype(bool)
    assert np.array_equal(mu_j[good], mu_p.numpy().view(np.uint32)[good])
    assert np.array_equal(sig_j[good], sig_p.numpy()[good])
    return good


def _dims_corpus():
    """tests/test_ht_scan_dims.py:test_dims_bucket_vs_oracle's inputs."""
    rng = np.random.default_rng(4242)
    zbp = 6

    def block(h, w, density):
        mag = rng.integers(0, 64, (h, w)).astype(np.int64)
        mag = np.where(rng.random((h, w)) < density, 0, mag)
        sign = np.where(mag > 0, rng.integers(0, 2, (h, w)).astype(np.int64),
                        0)
        return encode_cleanup(mag, sign, zbp)

    shapes = [(64, 64), (64, 64), (32, 14), (48, 7), (17, 29), (5, 3),
              (64, 1), (1, 64), (60, 34), (16, 16)]
    blocks = []
    for i, (w, h) in enumerate(shapes):
        data, lcup = block(h, w, density=rng.random())
        blocks.append((data, lcup, w, h))
        if i % 3 == 1:
            blocks.append(None)          # inert lane in the middle
    n = len(blocks)
    lmax = max(max(len(b[0]) for b in blocks if b), 4)
    cdat = np.zeros((n, lmax), np.uint8)
    lcups = np.full(n, 2, np.int64)
    pcups = np.zeros(n, np.int64)
    qws = np.zeros(n, np.int32)
    qhs = np.zeros(n, np.int32)
    for i, b in enumerate(blocks):
        if b is None:
            continue
        data, lcup, w, h = b
        buf = bytearray(data[:lcup])
        buf[lcup - 1] = 0xFF
        buf[lcup - 2] |= 0x0F
        scup = (data[lcup - 1] << 4) + (data[lcup - 2] & 0x0F)
        cdat[i, :lcup] = np.frombuffer(bytes(buf), np.uint8)
        lcups[i] = lcup
        pcups[i] = lcup - scup
        qws[i] = -(-w // 2)
        qhs[i] = -(-h // 2)
    msw, melw, vlcw = prepare_streams_batch(cdat, lcups, pcups)
    ms_lim, mel_lim = stream_limits(cdat, lcups, pcups)
    arrays = dict(msw=msw, melw=melw, vlcw=vlcw,
                  pLSB=np.full(n, 30 - zbp, np.int32),
                  maxbp=np.full(n, zbp + 1, np.int32),
                  ms_lim=ms_lim, mel_lim=mel_lim, qws=qws, qhs=qhs)
    return arrays, min(zbp + 1, 25)


def _highdepth_corpus():
    """12-bit frame lanes (tests/test_ht_scan_pallas.py high-depth case):
    the port's v3 lane arrays, held equal to the JAX package's here, and
    their ms_class."""
    rng = np.random.default_rng(2718)
    rng.integers(0, 256, (96, 128), dtype=np.uint8)   # that file's 1st draw
    img = rng.integers(0, 4096, (96, 128), dtype=np.uint16)
    data = encode_frame_htj2k(img, depth=12)
    hdr = parse_codestream(data, bitexact=True)
    fg = FP.FlatGeometry(hdr)
    fc = FP.build_v3_frame(fg, FP.parse_frame_flat(hdr, fg))
    phdr = port_parse(data, bitexact=True)
    pfg = port_fp.FlatGeometry(phdr)
    pfc = port_fp.build_v3_frame(pfg, port_fp.parse_frame_flat(phdr, pfg))
    args, _ = port_fp.finish_v3_numpy(pfg, [pfc], pfg.geom.total)
    plan = ASM.build_plan(fg)
    assert max(plan.bw, plan.bh) <= 64        # fits the 32x32-quad raster
    mb = int(fc["maxbp"][fc["qws"] > 0].max())
    msc = next(c for c in (8, 12, 16, 20, 25) if mb <= c)
    jargs, _ = FP.finish_v3(fg, [fc], fg.geom.total)
    for k in KEYS:
        assert np.array_equal(args[k], np.asarray(jargs[k])), k
    return {k: args[k] for k in KEYS}, msc


# Both corpora run at one shape class, so the JAX kernel compiles once: the
# 32x32-quad raster, the 12-bit lanes' MagSgn class, and the lanes and word
# widths of the larger corpus. Added lanes are inert (qws = qhs = 0, zero
# words, the pLSB / maxbp / limits of the decoder's inert lanes); added word
# columns are zeros, as the reader returns past a stream's end.
SHARED_MSC = 16


def _shared(arrays, msc):
    """`arrays` at the shared shape class (a new dict)."""
    assert msc <= SHARED_MSC
    n, widths = _SHARED_SHAPE
    m = len(arrays["qws"])
    fill = dict(pLSB=2, maxbp=32, ms_lim=2, mel_lim=2, qws=0, qhs=0)
    out = {}
    for k, a in arrays.items():
        if k in widths:
            b = np.zeros((n, widths[k]), a.dtype)
            b[:m, :a.shape[1]] = a
        else:
            b = np.full(n, fill[k], a.dtype)
            b[:m] = a
        out[k] = b
    return out


def _shared_shape():
    corpora = [_dims_corpus()[0], _highdepth_corpus()[0]]
    return (max(len(a["qws"]) for a in corpora),
            {k: max(a[k].shape[1] for a in corpora)
             for k in ("msw", "melw", "vlcw")})


_SHARED_SHAPE = _shared_shape()


@pytest.mark.parametrize("tight", [False, True],
                         ids=["valid", "u_bound_violated"])
def test_cleanup_ref_dims_corpus(tight):
    """Mixed shapes (64x64 .. 1x64), ragged lanes and inert lanes in one
    32x32-quad launch. `tight` lowers maxbp on some lanes so their U bound
    fails: ok must then agree lane by lane."""
    arrays = _shared(*_dims_corpus())
    if tight:
        arrays["maxbp"][[0, 3, 7]] = 2
    args = [arrays[k] for k in KEYS]
    want = decode_cleanup_scan_dims(*(jnp.asarray(a) for a in args),
                                    qw=32, qh=32, ms_class=SHARED_MSC)
    got = port.decode_cleanup_scan_dims(*(_tt(a) for a in args), 32, 32,
                                        SHARED_MSC)
    good = _assert_same(want, got)
    assert good.all() != tight
    # inert lanes emit zeros and stay ok
    inert = arrays["qws"] == 0
    assert inert.any() and good[inert].all()
    assert not got[0].numpy()[inert].any()


def test_vlc_pass_ref_sig_matches_jax():
    """The VLC pass alone: the ``sp`` field of its records is the JAX
    package's quad significance on every lane of the dims corpus, and
    quads outside a lane's (qws, qhs) hold 0."""
    arrays = _shared(*_dims_corpus())
    want = decode_cleanup_scan_dims(*(jnp.asarray(arrays[k]) for k in KEYS),
                                    qw=32, qh=32, ms_class=SHARED_MSC)
    rec = port.vlc_pass_ref(*(_tt(arrays[k]) for k in
                              ("melw", "vlcw", "mel_lim", "qws", "qhs")),
                            32, 32).numpy()
    assert rec.dtype == np.int32 and rec.shape == (len(arrays["qws"]), 32, 32)
    assert np.array_equal(rec & 0xF, np.asarray(want[1]))
    outside = ((np.arange(32)[None, None, :] >= arrays["qws"][:, None, None])
               | (np.arange(32)[None, :, None]
                  >= arrays["qhs"][:, None, None]))
    assert not rec[outside].any() and rec[~outside].any()
    assert int((rec >> 12).max()) <= 98


def test_cleanup_ref_highdepth():
    """12-bit frame lanes (tests/test_ht_scan_pallas.py high-depth case),
    through the jitted JAX kernel at the dims corpus' shape class: their
    own (qws, qhs) inside its 32x32-quad raster."""
    arrays, msc = _highdepth_corpus()
    real = len(arrays["qws"])
    arrays = _shared(arrays, msc)
    want = decode_cleanup_scan_dims(*(jnp.asarray(arrays[k]) for k in KEYS),
                                    qw=32, qh=32, ms_class=SHARED_MSC)
    got = port.decode_cleanup_scan_dims(*(_tt(arrays[k]) for k in KEYS), 32,
                                        32, SHARED_MSC)
    good = _assert_same(want, got)
    assert good.all() and got[0].numpy()[:real].any()


def test_cpu_tensors_never_launch_the_kernel():
    arrays, msc = _dims_corpus()
    before = (port.ht_vlc_pass.launches, port.ht_magsgn_pass.launches)
    port.decode_cleanup_scan_dims(*(_tt(arrays[k]) for k in KEYS), 32, 32,
                                  msc)
    assert (port.ht_vlc_pass.launches,
            port.ht_magsgn_pass.launches) == before
    with pytest.raises(ValueError):
        port.decode_cleanup_scan_dims(
            *(_tt(arrays[k]).to("meta") for k in KEYS), 32, 32, msc)


def test_bucket_dims_cached_window():
    """A v2 bucket's (qws, qhs): (qw, qh) on its first nreal lanes, 0 on
    the pads, for every nreal of a bucket, as the arange form gives them;
    with a cache both are views of one tensor a (device, lanes, qw, qh),
    so a call with another nreal adds nothing to the cache."""
    msw = torch.zeros((16, 4), dtype=torch.int32)
    cache = {}
    for nreal in range(17):
        qws, qhs = port._bucket_dims(msw, 5, 3, nreal, cache)
        real = torch.arange(16) < nreal
        assert torch.equal(qws, (real * 5).to(torch.int32))
        assert torch.equal(qhs, (real * 3).to(torch.int32))
        assert qws.is_contiguous() and qhs.is_contiguous()
        assert qws.untyped_storage().data_ptr() \
            == qhs.untyped_storage().data_ptr()
    assert len(cache) == 1
    port._bucket_dims(torch.zeros((8, 4), dtype=torch.int32), 5, 3, 2, cache)
    assert len(cache) == 2
    qws, _qhs = port._bucket_dims(msw, 5, 3, 7)       # no cache
    assert torch.equal(qws, ((torch.arange(16) < 7) * 5).to(torch.int32))
