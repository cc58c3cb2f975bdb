"""HT refinement passes, SigProp + MagRef, over cleanup output (T.814 7.4
and 7.5; the scalar oracle is ops/ht_dec.decode_sigprop/decode_magref,
the reference jpeg2000htdec.c:1016-1185).

Contract of ``ffmpeg_ht_tpu.ops.ht_refine.decode_refinement_scan``:

  inputs  mu     int32 (N, 2qh, 2qw): cleanup samples (uint32 bits held
                 as int32), raster order (ops/ht_scan);
          sig    int32 (N, qh, qw): the cleanup's 4-bit quad patterns;
          spw    int32 (N, Wsp): SigProp's forward Dref bits, unstuffed
                 into words (ops/ht_batch.prepare_sigprop_stream); words
                 past the end read as zero;
          mrw    int32 (N, Wmr): MagRef's backward Dref bits, unstuffed
                 and read forward by rank (prepare_magref_stream); a word
                 index past the end reads the last word (the host leaves
                 it zero);
          pLSB   int32 (N,): the *cleanup* pLSB; both passes run at
                 pLSB - 1 (ht_dec.py:653-658);
          has_sp, has_mr, causal  bool (N,): z_blk >= 2, z_blk == 3, and
                 the vertically-stripe-causal mode (CBLK_VSC);
          static qw, qh and the codeblock's real (w, h).
  output  int32 (N, 2qh, 2qw): the refined samples, zero outside (h, w).

MagRef touches the cleanup-significant samples only and reads its bits
in scan order (stripes of 4 rows top-down, columns left to right within
a stripe, rows top-down within a column), so every sample's bit index is
the exclusive rank of its sigma in that order: ``(0xFFFFFFFE | bit) <<
pL`` truncated to 32 bits masks the value, then ``| 1 << (pL - 1)``.

SigProp touches the others, 4x4 blocks along each stripe. A sample needs
a magnitude bit when its sigma is 0 and some neighbour is significant:
by the cleanup (sigma, static; on a causal codeblock the row below does
not count on a stripe's last row) or by this pass's own earlier bits
(REF of the neighbours already scanned: the whole row above, the column
to the left). A block reads its magnitude bits, then one sign bit per
sample that became significant: at most 32 bits, one 32-bit peek. A new
significant sample gets ``| 1 << pL | 1 << (pL - 1) | sign << 31``.

One difference from the JAX function, on purpose: on a stripe's first
row the JAX block body leaves the above-right neighbour's REF out of the
neighbourhood (ht_refine.py:191-202 reads ``top6[c]`` and ``top6[c + 1]``
but not ``top6[c + 2]``), where the oracle and the reference count it
(``_calc_mbr``: the OR of the three row-above states, whose REF and SCAN
are both set once that sample became significant in the stripe above).
This module follows the oracle. The two agree on every stream of the
tests made by the encoder (a sample there rarely becomes significant by
that neighbour alone) and part on random refinement bits, where this
module equals the oracle and the JAX function does not
(tests/test_torch_refine.py).

``refine_ref`` is the plain PyTorch version (int64 arithmetic masked to
32 bits: torch's CPU uint32 lacks shifts and comparisons). The wrapper
``decode_refinement_scan`` takes it for CPU tensors and launches the CUDA
kernel ``csrc/ht_refine.cu`` for CUDA tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ffmpeg_ht_tpu_torch.ops.ht_scan import _device_of, _to_i32_bits
from ffmpeg_ht_tpu_torch.utils import build
from ffmpeg_ht_tpu_torch.utils.device import check_tensor

_U32 = 0xFFFFFFFF
_I64 = torch.int64


def _stripes(h: int):
    """(row0, stripe_height): full 4-row stripes, then the remainder."""
    out = [(r0, 4) for r0 in range(0, h - h % 4, 4)]
    if h % 4:
        out.append((h - h % 4, h % 4))
    return out


def _scan_order(a, h: int, w: int):
    """(N, >=h, >=w) -> (N, h*w) in scan order."""
    N = a.shape[0]
    return torch.cat([a[:, r0:r0 + sh, :w].transpose(1, 2).reshape(N, w * sh)
                      for r0, sh in _stripes(h)], 1)


def _raster_order(f, h: int, w: int):
    """Inverse of ``_scan_order``: (N, h*w) -> (N, h, w)."""
    N, off, rows = f.shape[0], 0, []
    for _r0, sh in _stripes(h):
        rows.append(f[:, off:off + w * sh].reshape(N, w, sh).transpose(1, 2))
        off += w * sh
    return torch.cat(rows, 1)


def refine_ref(mu, sig, spw, mrw, pLSB, has_sp, has_mr, causal, qw: int,
               qh: int, w: int, h: int):
    """Plain PyTorch SigProp + MagRef (see the module docstring): all lanes
    in lockstep, MagRef as a rank and a gather, SigProp block by block
    with a 32-bit peek per block."""
    dev = mu.device
    N = mu.shape[0]
    H, W = 2 * qh, 2 * qw
    pL = pLSB.to(_I64)[:, None] - 1
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    valid = (yy < h) & (xx < w)
    ras = torch.where(valid, mu.to(_I64) & _U32, 0)
    # corner i of a quad sits at (dy, dx) = (i & 1, i >> 1)
    sig_up = sig.to(_I64).repeat_interleave(2, 1).repeat_interleave(2, 2)
    sigp = torch.where(valid, (sig_up >> ((yy & 1) + 2 * (xx & 1))) & 1, 0)

    # ---- MagRef: exclusive rank of sigma in scan order, one gather
    sig_f = _scan_order(sigp, h, w)
    rank = torch.cumsum(sig_f, 1) - sig_f
    words = mrw.to(_I64) & _U32
    widx = (rank >> 5).clamp(max=words.shape[1] - 1)
    bit = (torch.gather(words, 1, widx) >> (rank & 31)) & 1
    val_f = _scan_order(ras, h, w)
    newv = (val_f & (((0xFFFFFFFE | bit) << pL) & _U32)) | (1 << (pL - 1))
    val_f = torch.where((sig_f == 1) & has_mr[:, None], newv, val_f)
    ras[:, :h, :w] = _raster_order(val_f, h, w)

    # ---- SigProp: static neighbourhood sigma (zero ring outside)
    sp = F.pad(sigp, (1, 1, 1, 1))
    nbr = lambda dy, dx: sp[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
    or5 = nbr(-1, -1) | nbr(-1, 0) | nbr(-1, 1) | nbr(0, -1) | nbr(0, 1)
    below3 = nbr(1, -1) | nbr(1, 0) | nbr(1, 1)
    strip_last = ((yy & 3) == 3) | (yy == h - 1)
    below_on = ~(causal[:, None, None] & strip_last[None])
    sig_nb = or5 | torch.where(below_on, below3, 0)
    need_sp = has_sp.to(torch.bool)

    spws = spw.to(_I64) & _U32
    Wsp = spws.shape[1]

    def fetch(idx):
        v = torch.gather(spws, 1, idx.clamp(max=Wsp - 1)[:, None])[:, 0]
        return torch.where(idx >= Wsp, 0, v)

    pos = torch.zeros(N, dtype=_I64, device=dev)
    zero = torch.zeros(N, dtype=_I64, device=dev)
    above = [zero] * (w + 2)            # REF of the row above, cols -1..w
    for r0, sh in _stripes(h):
        # REF / sign of this stripe, [row][col + 1] (col -1 stays zero)
        ref = [[zero] * (w + 1) for _ in range(sh)]
        sgn = [[zero] * (w + 1) for _ in range(sh)]
        for x0 in range(0, w, 4):
            sh32 = pos & 31
            lo = fetch(pos >> 5) >> sh32
            hi = torch.where(sh32 == 0, 0,
                             (fetch((pos >> 5) + 1) << (32 - sh32)) & _U32)
            win = lo | hi
            cnt = zero
            cols = range(x0, min(x0 + 4, w))
            for x in cols:
                for r in range(sh):
                    y = r0 + r
                    if r == 0:       # the stripe above: all three scanned
                        dyn = above[x] | above[x + 1] | above[x + 2]
                    else:            # this stripe: up-left and up
                        dyn = ref[r - 1][x] | ref[r - 1][x + 1]
                    dyn = dyn | ref[r][x]                      # left
                    if r + 1 < sh:
                        dyn = dyn | ref[r + 1][x]              # down-left
                    need = need_sp & (sigp[:, y, x] == 0) \
                        & ((sig_nb[:, y, x] | dyn) != 0)
                    ref[r][x + 1] = torch.where(need, (win >> cnt) & 1, 0)
                    cnt = cnt + need
            off = cnt
            for x in cols:
                for r in range(sh):
                    sneed = ref[r][x + 1] == 1
                    sgn[r][x + 1] = torch.where(sneed, (win >> off) & 1, 0)
                    off = off + sneed
            pos = pos + off
        R = torch.stack([torch.stack(row[1:], 1) for row in ref], 1)
        S = torch.stack([torch.stack(row[1:], 1) for row in sgn], 1)
        ras[:, r0:r0 + sh, :w] |= (R << pL[:, :, None]) \
            | (R << (pL[:, :, None] - 1)) | (S << 31)
        above = [zero] + ref[sh - 1][1:] + [zero]
    return _to_i32_bits(ras)


def decode_refinement_scan(mu, sig, spw, mrw, pLSB, has_sp, has_mr, causal,
                           qw: int, qh: int, w: int, h: int):
    """Refined samples (N, 2qh, 2qw) int32. CPU tensors take
    ``refine_ref``; CUDA tensors launch ``csrc/ht_refine.cu``."""
    dev = _device_of(mu)
    if dev.type == "cpu":
        return refine_ref(mu, sig, spw, mrw, pLSB, has_sp, has_mr, causal,
                          qw, qh, w, h)
    if not (1 <= qw <= 32 and 1 <= qh <= 32 and 1 <= w <= 2 * qw
            and 1 <= h <= 2 * qh):
        raise ValueError(f"qw={qw}, qh={qh}, w={w}, h={h}: the kernel "
                         "covers codeblocks up to 64x64 inside their raster")
    N = mu.shape[0]
    check_tensor(mu, "mu", torch.int32, dev, 3, N)
    check_tensor(sig, "sig", torch.int32, dev, 3, N)
    if tuple(mu.shape) != (N, 2 * qh, 2 * qw) \
            or tuple(sig.shape) != (N, qh, qw):
        raise ValueError(f"mu {tuple(mu.shape)} / sig {tuple(sig.shape)} do "
                         f"not match qw={qw}, qh={qh}")
    for name, t in dict(spw=spw, mrw=mrw).items():
        check_tensor(t, name, torch.int32, dev, 2, N)
        if t.shape[1] == 0:
            raise ValueError(f"{name} has no words")
    check_tensor(pLSB, "pLSB", torch.int32, dev, 1, N)
    for name, t in dict(has_sp=has_sp, has_mr=has_mr, causal=causal).items():
        check_tensor(t, name, torch.bool, dev, 1, N)
    out = torch.empty_like(mu)
    if N == 0:
        return out
    err = build.load().lib.ht_refine_launch(
        mu.data_ptr(), sig.data_ptr(), spw.data_ptr(), spw.shape[1],
        mrw.data_ptr(), mrw.shape[1], pLSB.data_ptr(), has_sp.data_ptr(),
        has_mr.data_ptr(), causal.data_ptr(), N, qw, qh, w, h,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "ht_refine_launch")
    decode_refinement_scan.launches += 1
    return out


decode_refinement_scan.launches = 0     # CUDA kernel launches
