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

The two passes touch disjoint samples, and SigProp reads only the
cleanup's sigma and its own REF bits, so they run one after the other, as
two kernels of ``csrc/ht_refine.cu`` with a plain version each (int64
arithmetic masked to 32 bits: torch's CPU uint32 lacks shifts and
comparisons):

  ``ht_sigprop_pass`` / ``sigprop_pass_ref`` (sig, spw, has_sp, causal):
      SigProp's REF and sign bits as words, int32 (N, S, G, 2) with
      S = (qh + 1) // 2 stripes and G = (qw + 3) // 4 groups of 8 columns:
      word [s, g, 0] holds the samples of stripe s, columns 8g .. 8g + 7,
      that SigProp made significant, bit 4 * (x % 8) + y % 4 (scan
      order); word [s, g, 1] their signs in that order, bit k the sign of
      the k-th; zero elsewhere;
  ``ht_magref_pass`` / ``magref_pass_ref`` (mu, sig, mrw, pLSB, has_mr,
      words): the refined raster, MagRef applied and SigProp's words
      merged in, zero outside (h, w).

``refine_ref`` is their composition. The wrapper ``decode_refinement_scan``
takes it for CPU tensors and launches the two kernels for CUDA tensors.
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


def _word_dims(qw: int, qh: int):
    """(S, G) of SigProp's words: stripes of the raster, 8-column groups."""
    return (qh + 1) // 2, (qw + 3) // 4


def _pack_words(ref, sgn, qw: int, qh: int):
    """(N, 2qh, 2qw) REF and sign bits (0/1) -> (N, S, G, 2) int32 words:
    REF at bit 4 * (x % 8) + y % 4 of word [y // 4, x // 8, 0], the signs
    of a word's REF samples in that order in word [.., 1]."""
    N = ref.shape[0]
    S, G = _word_dims(qw, qh)

    def scan(m):        # (N, S, G, 32), bit k of the group at [..., k]
        m = F.pad(m.to(_I64), (0, 8 * G - 2 * qw, 0, 4 * S - 2 * qh))
        return m.reshape(N, S, 4, G, 8).permute(0, 1, 3, 4, 2) \
            .reshape(N, S, G, 32)
    r, sg = scan(ref), scan(sgn)
    nth = torch.cumsum(r, -1) - r
    shifts = torch.arange(32, device=ref.device)
    return _to_i32_bits(torch.stack([(r << shifts).sum(-1),
                                     ((sg & r) << nth).sum(-1)], -1))


def _unpack_words(words, qw: int, qh: int):
    """Inverse of ``_pack_words``: (REF, sign) int64 0/1, (N, 2qh, 2qw)."""
    N = words.shape[0]
    S, G = _word_dims(qw, qh)
    u = words.to(_I64) & _U32
    r = (u[..., 0, None] >> torch.arange(32, device=words.device)) & 1
    sg = ((u[..., 1, None] >> (torch.cumsum(r, -1) - r)) & 1) & r
    m = torch.stack([r, sg], 3).reshape(N, S, G, 2, 8, 4) \
        .permute(0, 3, 1, 5, 2, 4)
    m = m.reshape(N, 2, 4 * S, 8 * G)[:, :, :2 * qh, :2 * qw]
    return m[:, 0], m[:, 1]


def _sigma(sig, qw: int, qh: int, w: int, h: int):
    """(N, 2qh, 2qw) int64 0/1 sigma of the quad patterns, zero outside
    (h, w), and that validity mask. Corner i of a quad sits at (dy, dx) =
    (i & 1, i >> 1)."""
    yy = torch.arange(2 * qh, device=sig.device)[:, None]
    xx = torch.arange(2 * qw, device=sig.device)[None, :]
    valid = (yy < h) & (xx < w)
    sig_up = sig.to(_I64).repeat_interleave(2, 1).repeat_interleave(2, 2)
    return (torch.where(valid, (sig_up >> ((yy & 1) + 2 * (xx & 1))) & 1, 0),
            valid)


def sigprop_pass_ref(sig, spw, has_sp, causal, qw: int, qh: int, w: int,
                     h: int):
    """Plain SigProp: its REF and sign words (N, S, G, 2) int32 (see the
    module docstring). All lanes in lockstep, block by block with a 32-bit
    peek per block."""
    dev = sig.device
    N = sig.shape[0]
    H, W = 2 * qh, 2 * qw
    sigp, _valid = _sigma(sig, qw, qh, w, h)
    # static neighbourhood sigma (zero ring outside)
    yy = torch.arange(H, device=dev)[:, None]
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
    REF = torch.zeros((N, H, W), dtype=_I64, device=dev)
    SGN = torch.zeros_like(REF)
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
        REF[:, r0:r0 + sh, :w] = torch.stack(
            [torch.stack(row[1:], 1) for row in ref], 1)
        SGN[:, r0:r0 + sh, :w] = torch.stack(
            [torch.stack(row[1:], 1) for row in sgn], 1)
        above = [zero] + ref[sh - 1][1:] + [zero]
    return _pack_words(REF, SGN, qw, qh)


def magref_pass_ref(mu, sig, mrw, pLSB, has_mr, words, qw: int, qh: int,
                    w: int, h: int):
    """Plain MagRef, with SigProp's words merged in: the refined raster
    (N, 2qh, 2qw) int32, zero outside (h, w). MagRef is a rank and a
    gather."""
    pL = pLSB.to(_I64)[:, None] - 1
    sigp, valid = _sigma(sig, qw, qh, w, h)
    ras = torch.where(valid, mu.to(_I64) & _U32, 0)
    # exclusive rank of sigma in scan order, one gather
    sig_f = _scan_order(sigp, h, w)
    rank = torch.cumsum(sig_f, 1) - sig_f
    mrws = mrw.to(_I64) & _U32
    widx = (rank >> 5).clamp(max=mrws.shape[1] - 1)
    bit = (torch.gather(mrws, 1, widx) >> (rank & 31)) & 1
    val_f = _scan_order(ras, h, w)
    newv = (val_f & (((0xFFFFFFFE | bit) << pL) & _U32)) | (1 << (pL - 1))
    val_f = torch.where((sig_f == 1) & has_mr[:, None], newv, val_f)
    ras[:, :h, :w] = _raster_order(val_f, h, w)
    # SigProp's new significant samples: | 1 << pL | 1 << (pL - 1) | sign
    R, S = (m[:, :h, :w] for m in _unpack_words(words, qw, qh))
    pL = pL[:, :, None]
    ras[:, :h, :w] |= (R << pL) | (R << (pL - 1)) | (S << 31)
    return _to_i32_bits(ras)


def refine_ref(mu, sig, spw, mrw, pLSB, has_sp, has_mr, causal, qw: int,
               qh: int, w: int, h: int):
    """Plain PyTorch SigProp + MagRef (see the module docstring):
    ``magref_pass_ref`` merging ``sigprop_pass_ref``'s words."""
    words = sigprop_pass_ref(sig, spw, has_sp, causal, qw, qh, w, h)
    return magref_pass_ref(mu, sig, mrw, pLSB, has_mr, words, qw, qh, w, h)


def _check_shape(qw: int, qh: int, w: int, h: int):
    if not (1 <= qw <= 32 and 1 <= qh <= 32 and 1 <= w <= 2 * qw
            and 1 <= h <= 2 * qh):
        raise ValueError(f"qw={qw}, qh={qh}, w={w}, h={h}: the kernels "
                         "cover codeblocks up to 64x64 inside their raster")


def _check_words(t, name, dev, N):
    check_tensor(t, name, torch.int32, dev, 2, N)
    if t.shape[1] == 0:
        raise ValueError(f"{name} has no words")


def ht_sigprop_pass(sig, spw, has_sp, causal, qw: int, qh: int, w: int,
                    h: int):
    """SigProp's REF and sign words (N, S, G, 2) int32. CPU tensors take
    ``sigprop_pass_ref``; CUDA tensors launch ``ht_sigprop_pass`` of
    ``csrc/ht_refine.cu``."""
    dev = _device_of(sig)
    if dev.type == "cpu":
        return sigprop_pass_ref(sig, spw, has_sp, causal, qw, qh, w, h)
    _check_shape(qw, qh, w, h)
    N = sig.shape[0]
    check_tensor(sig, "sig", torch.int32, dev, 3, N)
    if tuple(sig.shape) != (N, qh, qw):
        raise ValueError(f"sig {tuple(sig.shape)} does not match qw={qw}, "
                         f"qh={qh}")
    _check_words(spw, "spw", dev, N)
    for name, t in dict(has_sp=has_sp, causal=causal).items():
        check_tensor(t, name, torch.bool, dev, 1, N)
    words = torch.empty((N, *_word_dims(qw, qh), 2), dtype=torch.int32,
                        device=dev)
    if N == 0:
        return words
    with torch.cuda.device(dev):
        err = build.load().lib.ht_sigprop_pass_launch(
            sig.data_ptr(), spw.data_ptr(), spw.shape[1], has_sp.data_ptr(),
            causal.data_ptr(), N, qw, qh, w, h, words.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "ht_sigprop_pass_launch")
    ht_sigprop_pass.launches += 1
    return words


def ht_magref_pass(mu, sig, mrw, pLSB, has_mr, words, qw: int, qh: int,
                   w: int, h: int):
    """The refined raster (N, 2qh, 2qw) int32: MagRef, SigProp's `words`
    merged in. CPU tensors take ``magref_pass_ref``; CUDA tensors launch
    ``ht_magref_pass`` of ``csrc/ht_refine.cu``."""
    dev = _device_of(mu)
    if dev.type == "cpu":
        return magref_pass_ref(mu, sig, mrw, pLSB, has_mr, words, qw, qh, w,
                               h)
    _check_shape(qw, qh, w, h)
    N = mu.shape[0]
    for name, t, shape in (("mu", mu, (N, 2 * qh, 2 * qw)),
                           ("sig", sig, (N, qh, qw)),
                           ("words", words, (N, *_word_dims(qw, qh), 2))):
        check_tensor(t, name, torch.int32, dev, len(shape), N)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)} does not match "
                             f"qw={qw}, qh={qh}")
    _check_words(mrw, "mrw", dev, N)
    check_tensor(pLSB, "pLSB", torch.int32, dev, 1, N)
    check_tensor(has_mr, "has_mr", torch.bool, dev, 1, N)
    out = torch.empty_like(mu)
    if N == 0:
        return out
    with torch.cuda.device(dev):
        err = build.load().lib.ht_magref_pass_launch(
            mu.data_ptr(), sig.data_ptr(), mrw.data_ptr(), mrw.shape[1],
            pLSB.data_ptr(), has_mr.data_ptr(), words.data_ptr(), N, qw,
            qh, w, h, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "ht_magref_pass_launch")
    ht_magref_pass.launches += 1
    return out


def decode_refinement_scan(mu, sig, spw, mrw, pLSB, has_sp, has_mr, causal,
                           qw: int, qh: int, w: int, h: int):
    """Refined samples (N, 2qh, 2qw) int32. CPU tensors take
    ``refine_ref``; CUDA tensors launch the two kernels of
    ``csrc/ht_refine.cu``: ``ht_sigprop_pass``, then ``ht_magref_pass``
    merging its words."""
    if _device_of(mu).type == "cpu":
        return refine_ref(mu, sig, spw, mrw, pLSB, has_sp, has_mr, causal,
                          qw, qh, w, h)
    words = ht_sigprop_pass(sig, spw, has_sp, causal, qw, qh, w, h)
    out = ht_magref_pass(mu, sig, mrw, pLSB, has_mr, words, qw, qh, w, h)
    decode_refinement_scan.launches += 1
    return out


ht_magref_pass.launches = 0             # CUDA kernel launches
ht_sigprop_pass.launches = 0            # CUDA kernel launches
decode_refinement_scan.launches = 0     # calls that launched the pair
