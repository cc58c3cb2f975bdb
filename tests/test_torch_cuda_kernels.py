"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``cuda``: needs an NVIDIA card and nvcc (the kernels are built from
ffmpeg_ht_tpu_torch/csrc at first use) and skips without them. Run on a
card with

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Integer kernels: the match is exact (the VLC pass's records on every
lane; the MagSgn pass's mu / sig / ok on every lane from the same
records; the pair's mu / sig on every ok lane and ok on every lane; RCT
samples bit for bit). The lanes are ragged (odd quad widths, every shape
up to the raster), with inert lanes and lanes whose U bound fails.
"""

import numpy as np
import pytest
import torch

from ffmpeg_ht_tpu_torch.ops import ht_scan, mct_cuda
from ffmpeg_ht_tpu_torch.ops.ht_batch import (prepare_streams_batch,
                                              stream_limits)
from ffmpeg_ht_tpu_torch.ops.ht_enc import encode_cleanup

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _lanes(seed, n, qw, qh):
    """n random codeblocks (mixed shapes, depths, inert lanes) as lane
    arrays: (dict of int32 numpy arrays, ms_class)."""
    rng = np.random.default_rng(seed)
    rows, lcups, pcups, qws, qhs, zbps = [], [], [], [], [], []
    for i in range(n):
        if i % 7 == 3:                            # inert lane
            rows.append(b"")
            lcups.append(2)
            pcups.append(0)
            qws.append(0)
            qhs.append(0)
            zbps.append(0)
            continue
        w = int(rng.integers(1, 2 * qw + 1))
        h = int(rng.integers(1, 2 * qh + 1))
        zbp = int(rng.choice([3, 6, 10, 14, 20]))
        mag = rng.integers(0, 1 << zbp, (h, w)).astype(np.int64)
        mag = np.where(rng.random((h, w)) < rng.random(), 0, mag)
        sign = np.where(mag > 0, rng.integers(0, 2, (h, w)), 0)
        data, lcup = encode_cleanup(mag, sign.astype(np.int64), zbp)
        buf = bytearray(data[:lcup])
        scup = (data[lcup - 1] << 4) + (data[lcup - 2] & 0x0F)
        buf[lcup - 1] = 0xFF
        buf[lcup - 2] |= 0x0F
        rows.append(bytes(buf))
        lcups.append(lcup)
        pcups.append(lcup - scup)
        qws.append(-(-w // 2))
        qhs.append(-(-h // 2))
        zbps.append(zbp)
    cdat = np.zeros((n, max(max(len(r) for r in rows), 4)), np.uint8)
    for i, r in enumerate(rows):
        cdat[i, :len(r)] = np.frombuffer(r, np.uint8)
    lc, pc = np.asarray(lcups, np.int64), np.asarray(pcups, np.int64)
    msw, melw, vlcw = prepare_streams_batch(cdat, lc, pc)
    ms_lim, mel_lim = stream_limits(cdat, lc, pc)
    zb = np.asarray(zbps, np.int32)
    maxbp = zb + 1
    maxbp[[1, 2, 5]] = 1                         # U-bound violations
    arrays = dict(msw=msw, melw=melw, vlcw=vlcw, pLSB=30 - zb, maxbp=maxbp,
                  ms_lim=ms_lim, mel_lim=mel_lim,
                  qws=np.asarray(qws, np.int32), qhs=np.asarray(qhs, np.int32))
    keys = ("msw", "melw", "vlcw", "pLSB", "maxbp", "ms_lim", "mel_lim",
            "qws", "qhs")
    out = [np.ascontiguousarray(arrays[k]) for k in keys]
    out = [a.view(np.int32) if a.dtype == np.uint32 else a.astype(np.int32)
           for a in out]
    return out, min(int(zb.max()) + 1, 25)


def _launches():
    return ht_scan.ht_vlc_pass.launches, ht_scan.ht_magsgn_pass.launches


@pytest.mark.parametrize("qw,qh,n,seed", [(32, 32, 200, 1), (8, 8, 333, 2),
                                          (16, 4, 129, 3)])
def test_cleanup_kernel_matches_ref(cuda, qw, qh, n, seed):
    arrays, msc = _lanes(seed, n, qw, qh)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    before = _launches()
    mu, sig, ok = ht_scan.decode_cleanup_scan_dims(*args, qw, qh, msc)
    torch.cuda.synchronize()
    assert _launches() == (before[0] + 1, before[1] + 1)
    mu_r, sig_r, ok_r = ht_scan.cleanup_ref(*args, qw, qh, msc)
    assert torch.equal(ok, ok_r)
    assert not bool(ok_r.all()) and int(ok_r.sum()) > n // 2
    assert torch.equal(mu[ok_r], mu_r[ok_r])
    assert torch.equal(sig[ok_r], sig_r[ok_r])


@pytest.mark.parametrize("qw,qh,n,seed", [(32, 32, 300, 11), (16, 16, 257, 12),
                                          (16, 32, 97, 13)])
def test_vlc_pass_kernel_matches_ref(cuda, qw, qh, n, seed):
    arrays, _msc = _lanes(seed, n, qw, qh)
    msw, melw, vlcw, pLSB, maxbp, ms_lim, mel_lim, qws, qhs = \
        [torch.from_numpy(a).to(cuda) for a in arrays]
    assert (qws.remainder(2) == 1).any() and (qws == 0).any()
    before = ht_scan.ht_vlc_pass.launches
    rec = ht_scan.ht_vlc_pass(melw, vlcw, mel_lim, qws, qhs, qw, qh)
    torch.cuda.synchronize()
    assert ht_scan.ht_vlc_pass.launches == before + 1
    want = ht_scan.vlc_pass_ref(melw, vlcw, mel_lim, qws, qhs, qw, qh)
    assert rec.dtype == torch.int32 and torch.equal(rec, want)


@pytest.mark.parametrize("random_records", [False, True])
@pytest.mark.parametrize("qw,qh,n,seed", [(32, 32, 300, 21), (16, 16, 257, 22),
                                          (32, 8, 97, 23)])
def test_magsgn_pass_kernel_matches_ref(cuda, qw, qh, n, seed,
                                        random_records):
    """From the same records, mu / sig / ok agree on every lane, the lanes
    whose U bound fails included; random records exercise every field."""
    arrays, msc = _lanes(seed, n, qw, qh)
    msw, melw, vlcw, pLSB, maxbp, ms_lim, mel_lim, qws, qhs = \
        [torch.from_numpy(a).to(cuda) for a in arrays]
    rec = ht_scan.vlc_pass_ref(melw, vlcw, mel_lim, qws, qhs, qw, qh)
    if random_records:
        rng = np.random.default_rng(seed)
        f = lambda hi: rng.integers(0, hi, (n, qh, qw))
        rec = torch.from_numpy((f(16) | f(16) << 4 | f(16) << 8 | f(8) << 12)
                               .astype(np.int32)).to(cuda)
    before = ht_scan.ht_magsgn_pass.launches
    mu, sig, ok = ht_scan.ht_magsgn_pass(rec, msw, pLSB, maxbp, ms_lim, qws,
                                         qhs, qw, qh, msc)
    torch.cuda.synchronize()
    assert ht_scan.ht_magsgn_pass.launches == before + 1
    mu_r, sig_r, ok_r = ht_scan.magsgn_pass_ref(rec, msw, pLSB, maxbp, ms_lim,
                                                qws, qhs, qw, qh, msc)
    assert not bool(ok_r.all())
    assert torch.equal(ok, ok_r)
    assert torch.equal(mu, mu_r) and torch.equal(sig, sig_r)


def test_cleanup_kernel_rejects_bad_args(cuda):
    arrays, msc = _lanes(4, 20, 8, 8)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    with pytest.raises(TypeError):
        ht_scan.decode_cleanup_scan_dims(args[0].to(torch.int64), *args[1:],
                                         8, 8, msc)
    with pytest.raises(ValueError):
        ht_scan.decode_cleanup_scan_dims(*args, 33, 8, msc)
    with pytest.raises(ValueError):
        ht_scan.decode_cleanup_scan_dims(args[0], args[1], args[2],
                                         args[3][:-1], *args[4:], 8, 8, msc)


@pytest.mark.parametrize("cbps", [8, 10, 12, 16])
@pytest.mark.parametrize("shape", [(2160, 4096), (37, 53)])
def test_rct_kernel_matches_ref(cuda, cbps, shape):
    g = torch.Generator().manual_seed(cbps)
    lim = 1 << cbps
    y = [torch.randint(-lim, lim, shape, generator=g, dtype=torch.int32)
         .to(cuda) for _ in range(3)]
    ref = mct_cuda.rct_writeframe_ref(*y, cbps)
    before = mct_cuda.rct_writeframe.launches
    got = mct_cuda.rct_writeframe(*y, cbps)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    dtype = torch.uint8 if cbps <= 8 else torch.int16
    out = torch.empty(3 * y[0].numel(), dtype=dtype, device=cuda)
    mct_cuda.rct_writeframe(*y, cbps, out=out)
    assert mct_cuda.rct_writeframe.launches == before + 2
    want = torch.cat([mct_cuda.narrow(c, dtype).reshape(-1) for c in ref])
    assert torch.equal(out, want)
