"""HT cleanup pass over a frame's codeblock lanes (T.814 cleanup decode).

Contract of ``ffmpeg_ht_tpu.ops.ht_scan.decode_cleanup_scan_dims`` (and of
the Pallas kernel ``ht_scan_pallas.decode_cleanup_pallas`` that shares it):

  inputs  msw / melw / vlcw  (N, W_*) dense bit streams built on the host
          by ``ops/ht_batch.prepare_streams_with_limits`` or, in the
          decoder, by one native pass (``utils/native.ht_prepare_v3``)
          (uint32 words, held here as int32 bit patterns);
          pLSB, maxbp, ms_lim, mel_lim, qws, qhs  int32 (N,);
          static qw, qh <= 32 (the lane raster is (2qh, 2qw)) and
          ms_class, a bound on every decoded lane's maxbp.
  outputs mu   int32 (N, 2qh, 2qw): uint32 sample words as int32 bits
               (bit 31 sign, magnitude above pLSB), raster order;
          sig  int32 (N, qh, qw): 4-bit quad significance patterns;
          ok   bool (N,): false when some quad's U exceeds maxbp.

A lane decodes only the quads inside its own (qws, qhs); quads beyond
consume no stream bits and emit zeros, and ``qws == 0`` makes a lane
inert (nothing read, zeros out, ok true). Stream reads follow the
reference's end-of-segment rule: a word index ``>= lim`` reads all ones
(the 0xFF synthesis, jpeg2000htdec.c:207-221) and any other index past
the stored words reads zero; the VLC stream has no limit.

The pass is split in two where T.814 allows it: MEL and VLC decoding of
quad row r needs only the significance of row r - 1, and only U needs
the exponents of the row above, which come from MagSgn. So

1. the VLC pass (``ht_vlc_pass``) decodes MEL, CxtVLC and the U-VLC
   pairs of a whole codeblock and writes one record per quad into an
   (N, qh, qw) int32 tensor::

       bits  0-3   sp   significance pattern (corner i = bit i)
       bits  4-7   ek   e_k: corners whose MagSgn count is one less
       bits  8-11  e1   e_1: corners with an implicit leading one
       bits 12-18  u    U-VLC value, <= 98; on the initial row the MEL
                        bonus and the ``p0 > 2`` case are folded in

   Quads outside the lane's (qws, qhs) hold 0.
2. the MagSgn pass (``ht_magsgn_pass``) turns the records into
   (mu, sig, ok): U from the row above's exponents (``1 + u`` on row 0,
   ``max(1, gamma(sp) * (kmax - 1)) + u`` below it), the sample counts
   ``m_i = min(sp_i * U - ek_i, min(ms_class, 25))``, and the samples
   read from the MagSgn stream, quad after quad along the row, corners
   0..3 of a quad in order. Corner i sits at (dy, dx) = (i & 1, i >> 1).

``vlc_pass_ref`` and ``magsgn_pass_ref`` are the plain PyTorch versions
and ``cleanup_ref`` their composition. The wrappers take the plain
version for CPU tensors and launch the CUDA kernels
``csrc/ht_vlc_pass.cu`` and ``csrc/ht_magsgn_pass.cu`` for CUDA tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ffmpeg_ht_tpu_torch.ops import tables as tb
from ffmpeg_ht_tpu_torch.utils import build
from ffmpeg_ht_tpu_torch.utils.device import check_tensor

_NO_LIM = 1 << 29          # VLC stream: no 0xFF synthesis, zeros past W
_U32 = 0xFFFFFFFF
_I64 = torch.int64

# 5-bit reversal: MEL run values are stored MSB-first
_REV5 = np.array([int(f"{i:05b}"[::-1], 2) for i in range(32)], np.int64)


def _to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensor with the same bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


class _Stream:
    """Bit reader over one (N, W) word stream, one position per lane."""

    def __init__(self, words, lim):
        n, self.W = words.shape
        self.w = words.to(_I64) & _U32
        if lim is None:
            lim = torch.full((n,), _NO_LIM, dtype=_I64, device=words.device)
        self.lim = lim.to(_I64)[:, None]
        self.pos = torch.zeros(n, dtype=_I64, device=words.device)

    def _fetch(self, idx):
        v = torch.gather(self.w, 1, idx.clamp(0, self.W - 1))
        v = torch.where(idx >= self.W, 0, v)
        return torch.where(idx >= self.lim, _U32, v)

    def peek(self, off=None):
        """32 bits (LSB-first) at each lane's position, or at position +
        off for an (N, k) offset matrix."""
        p = self.pos[:, None] if off is None else self.pos[:, None] + off
        sh = p & 31
        lo = self._fetch(p >> 5) >> sh
        hi = torch.where(sh == 0, 0,
                         (self._fetch((p >> 5) + 1) << (32 - sh)) & _U32)
        v = lo | hi
        return v[:, 0] if off is None else v


class _Tables:
    def __init__(self, device):
        t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
        self.cxt = t(tb.CXTVLC_PACKED)          # (2, 1024) packed entries
        self.mel_e = t(tb.MEL_E)
        self.rev5 = t(_REV5)
        self.u_val = t(tb.UVLC_PREFIX_VALUE)
        self.u_len = t(tb.UVLC_PREFIX_DROP)


def _ctx_first(sp):
    """Initial-row context from the left quad (jpeg2000htdec.c:648-650)."""
    return ((sp | (sp >> 1)) & 1) + (((sp >> 2) & 1) << 1) \
        + (((sp >> 3) & 1) << 2)


def _west(sp):
    """Right-column significance of a quad (its east neighbour's W term)."""
    return ((sp >> 2) | (sp >> 3)) & 1


def _gamma(sp):
    pc = (sp & 1) + ((sp >> 1) & 1) + ((sp >> 2) & 1) + ((sp >> 3) & 1)
    return (pc > 1).to(_I64)


_REC_U_SHIFT = 12


def vlc_pass_ref(melw, vlcw, mel_lim, qws, qhs, qw: int, qh: int):
    """Plain PyTorch VLC pass: (N, qh, qw) int32 quad records (see the
    module docstring). All lanes advance in lockstep through the quad
    pairs with ``torch.gather`` word fetches and direct table indexing."""
    dev = melw.device
    N = melw.shape[0]
    T = _Tables(dev)
    mel, vlc = _Stream(melw, mel_lim), _Stream(vlcw, None)
    qws, qhs = qws.to(_I64), qhs.to(_I64)
    zero = torch.zeros(N, dtype=_I64, device=dev)
    mel_k, mel_run, mel_one = zero.clone(), zero.clone(), zero.clone()

    def mel_sym(active):
        """One MEL symbol per active lane (jpeg2000htdec.c:462-495)."""
        nonlocal mel_k, mel_run, mel_one
        fresh = active & (mel_run == 0) & (mel_one == 0)
        ev = T.mel_e[mel_k]
        pk = mel.peek()
        hit = fresh & ((pk & 1) == 1)
        miss = fresh & ((pk & 1) == 0)
        mv = (pk >> 1) & ((1 << ev) - 1)
        mrun = T.rev5[mv] >> (5 - ev)
        mel.pos = mel.pos + torch.where(miss, 1 + ev, fresh.to(_I64))
        mel_run = torch.where(hit, 1 << ev, torch.where(miss, mrun, mel_run))
        mel_k = torch.where(hit, (mel_k + 1).clamp(max=12),
                            torch.where(miss, (mel_k - 1).clamp(min=0), mel_k))
        mel_one = torch.where(miss, 1, torch.where(hit, 0, mel_one))
        in_run = active & (mel_run > 0)
        mel_run = torch.where(in_run, mel_run - 1, mel_run)
        mel_one = torch.where(active & ~in_run, 0, mel_one)
        return (active & ~in_run).to(_I64)

    def cxt_quad(tbl, code, ctx, active):
        """MEL-gated CxtVLC decode of one quad (jpeg2000htdec.c:510-531):
        (rho-offset, sig pattern, e_k, e_1, codeword length)."""
        sym = mel_sym(active & (ctx == 0))
        read = active & ((ctx != 0) | (sym == 1))
        e = torch.where(read, T.cxt[tbl][(ctx << 7) | code], 0)
        return (e & 1, (e >> 4) & 0xF, (e >> 8) & 0xF, (e >> 12) & 0xF,
                (e & 0xF) >> 1)

    def sig_emb_pair(tbl, c1, c2_of, a1, a2):
        pk = vlc.peek()
        r1, sp1, ek1, e11, ln1 = cxt_quad(tbl, pk & 0x7F, c1, a1)
        r2, sp2, ek2, e12, ln2 = cxt_quad(tbl, (pk >> ln1) & 0x7F,
                                          c2_of(sp1), a2)
        vlc.pos = vlc.pos + ln1 + ln2
        return (r1, sp1, ek1, e11), (r2, sp2, ek2, e12)

    def prefix(pk, off, active):
        b = (pk >> off) & 7
        return (torch.where(active, T.u_val[b], 0),
                off + torch.where(active, T.u_len[b], 0))

    def suffix(pk, off, p, active):
        is3, is5 = active & (p == 3), active & (p > 3)
        b = pk >> off
        return (torch.where(is3, b & 1, torch.where(is5, b & 31, 0)),
                off + torch.where(is3, 1, torch.where(is5, 5, 0)))

    def ext(pk, off, s, active):
        has = active & (s >= 28)
        return (torch.where(has, (pk >> off) & 15, 0),
                off + torch.where(has, 4, 0))

    def u_pair(initial, r1, r2, a1, a2):
        """U-VLC pair decode (jpeg2000htdec.c:338-388, 666-712, 828-854);
        on the initial row the MEL bonus is folded into u."""
        both = a1 & a2 & (r1 == 1) & (r2 == 1)
        only1 = a1 & (r1 == 1) & ~(a2 & (r2 == 1))
        only2 = a2 & (r2 == 1) & (r1 == 0)
        first = both | only1 | only2
        pk = vlc.peek()
        if initial:
            sym = mel_sym(both)
            mel1, mel0 = both & (sym == 1), both & (sym == 0)
            p0, off = prefix(pk, zero, first)
            big, small = mel0 & (p0 > 2), mel0 & (p0 <= 2)
            second = mel1 | small
            p1, off = prefix(pk, off, second)
            bit = torch.where(big, (pk >> off) & 1, 0)
            off = off + big.to(_I64)
        else:
            second = both
            p0, off = prefix(pk, zero, first)
            p1, off = prefix(pk, off, second)
        s0, off = suffix(pk, off, p0, first)
        s1, off = suffix(pk, off, p1, second)
        x0, off = ext(pk, off, s0, first)
        x1, off = ext(pk, off, s1, second)
        vlc.pos = vlc.pos + off
        ua, ub = p0 + s0 + 4 * x0, p1 + s1 + 4 * x1
        if initial:
            u1 = torch.where(both, ua + 2 * mel1,
                             torch.where(only1, ua, 0))
            u2 = torch.where(mel1, ub + 2, torch.where(
                big, bit + 1, torch.where(small, ub,
                                          torch.where(only2, ua, 0))))
        else:
            u1 = torch.where(both | only1, ua, 0)
            u2 = torch.where(both, ub, torch.where(only2, ua, 0))
        return u1, u2

    def record(q, u):
        return q[1] | (q[2] << 4) | (q[3] << 8) | (u << _REC_U_SHIFT)

    rec = torch.zeros((N, qh, qw), dtype=_I64, device=dev)
    rows = min(int(qhs.max()), qh) if N else 0
    pairs = (min(int(qws.max()), qw) + 1) // 2 if N else 0
    zcol = torch.zeros((N, 1), dtype=_I64, device=dev)
    for r in range(rows):
        rowact = r < qhs
        if r:
            # row-above significance (jpeg2000htdec.c:784-919)
            spa = rec[:, r - 1] & 0xF
            sN, sNE = (spa >> 1) & 1, (spa >> 3) & 1
            sNW = torch.cat([zcol, sNE[:, :-1]], 1)
            sNF = torch.cat([sN[:, 1:], zcol], 1)
            cA = torch.cat([(sN | sNW) | ((sNE | sNF) << 2), zcol], 1)
        context, wprev = zero, zero
        for p in range(pairs):
            j1, j2 = 2 * p, 2 * p + 1
            a1 = rowact & (j1 < qws)
            a2 = rowact & (j2 < qws)
            if r == 0:
                q1, q2 = sig_emb_pair(0, context, _ctx_first, a1, a2)
                context = torch.where(a2, _ctx_first(q2[1]), torch.where(
                    a1, _ctx_first(q1[1]), context))
                u1, u2 = u_pair(True, q1[0], q2[0], a1, a2)
            else:
                c2 = cA[:, min(j2, qw)]
                q1, q2 = sig_emb_pair(
                    1, cA[:, j1] | (wprev << 1),
                    lambda sp: c2 | (_west(sp) << 1), a1, a2)
                u1, u2 = u_pair(False, q1[0], q2[0], a1, a2)
                wprev = torch.where(a2, _west(q2[1]), torch.where(
                    a1, _west(q1[1]), wprev))
            rec[:, r, j1] = record(q1, u1)
            if j2 < qw:
                rec[:, r, j2] = record(q2, u2)
    return rec.to(torch.int32)


def magsgn_pass_ref(rec, msw, pLSB, maxbp, ms_lim, qws, qhs, qw: int,
                    qh: int, ms_class: int):
    """Plain PyTorch MagSgn pass: quad records -> (mu, sig, ok), one quad
    row of every lane at a time; each quad's MagSgn bit offset is a
    ``cumsum`` of the sample counts along the row."""
    dev = msw.device
    N = msw.shape[0]
    clamp = min(int(ms_class), 25)
    ms = _Stream(msw, ms_lim)
    rec = rec.to(_I64)
    qws, qhs = qws.to(_I64), qhs.to(_I64)
    pLSB = pLSB.to(_I64)[:, None]
    maxbp = maxbp.to(_I64)[:, None]
    corner = torch.arange(4, device=dev)
    cols = torch.arange(qw, device=dev)[None, :]
    mu = torch.zeros((N, qh, qw, 4), dtype=_I64, device=dev)
    sig = torch.zeros((N, qh, qw), dtype=_I64, device=dev)
    ok = torch.ones(N, dtype=torch.bool, device=dev)
    zcol = torch.zeros((N, 1), dtype=_I64, device=dev)
    e_prev = torch.zeros((N, qw, 4), dtype=_I64, device=dev)
    bit = lambda x: (x[..., None] >> corner) & 1        # (N, qw, 4)
    rows = min(int(qhs.max()), qh) if N else 0
    for r in range(rows):
        act = (r < qhs)[:, None] & (cols < qws[:, None])   # (N, qw)
        q = torch.where(act, rec[:, r], 0)
        sp, ek, e1 = q & 0xF, (q >> 4) & 0xF, (q >> 8) & 0xF
        u = q >> _REC_U_SHIFT
        if r == 0:
            U = 1 + u
        else:
            # kmax over the row above's bottom exponents
            # (jpeg2000htdec.c:784-919)
            eN, eNE = e_prev[:, :, 1], e_prev[:, :, 3]
            eNW = torch.cat([zcol, eNE[:, :-1]], 1)
            eNF = torch.cat([eN[:, 1:], zcol], 1)
            kmax = torch.maximum(torch.maximum(eNW, eN),
                                 torch.maximum(eNE, eNF))
            U = (_gamma(sp) * (kmax - 1)).clamp(min=1) + u
        ok = ok & (~act | (U <= maxbp)).all(1)
        # MagSgn recovery (jpeg2000htdec.c:395-427)
        m = (bit(sp) * U[..., None] - bit(ek)).clamp(max=clamp)
        do = (act[..., None] & (m > 0)).reshape(N, 4 * qw)
        mm = torch.where(do, m.reshape(N, 4 * qw), 0)
        v = ms.peek(torch.cumsum(mm, 1) - mm) & ((1 << mm) - 1)
        ms.pos = ms.pos + mm.sum(1)
        v = v + (bit(e1).reshape(N, 4 * qw) << mm)
        e_n = torch.frexp((v | 1).to(torch.float64))[1].to(_I64)
        val = ((((v >> 1) + 1) << pLSB) | (1 << (pLSB - 1))
               | ((v & 1) << 31)) & _U32
        mu[:, r] = torch.where(do, val, 0).view(N, qw, 4)
        e_prev = torch.where(do, e_n, 0).view(N, qw, 4)
        sig[:, r] = sp
    # corner i of a quad sits at (dy, dx) = (i & 1, i >> 1)
    ras = mu.view(N, qh, qw, 2, 2).permute(0, 1, 4, 2, 3) \
        .reshape(N, 2 * qh, 2 * qw)
    return _to_i32_bits(ras), sig.to(torch.int32), ok


def cleanup_ref(msw, melw, vlcw, pLSB, maxbp, ms_lim, mel_lim, qws, qhs,
                qw: int, qh: int, ms_class: int):
    """Plain PyTorch cleanup decode, the whole contract of the module
    docstring: ``magsgn_pass_ref(vlc_pass_ref(...), ...)``."""
    rec = vlc_pass_ref(melw, vlcw, mel_lim, qws, qhs, qw, qh)
    return magsgn_pass_ref(rec, msw, pLSB, maxbp, ms_lim, qws, qhs, qw, qh,
                           ms_class)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

_DEVICE_TABLES = {}


def _device_tables(device):
    """The two CxtVLC tables as one (2048,) int32 tensor on `device`,
    uploaded once per device."""
    t = _DEVICE_TABLES.get(device)
    if t is None:
        t = torch.as_tensor(tb.CXTVLC_PACKED.astype(np.int32).reshape(-1),
                            device=device).contiguous()
        _DEVICE_TABLES[device] = t
    return t


def _check_dims(qw: int, qh: int):
    if not (1 <= qw <= 32 and 1 <= qh <= 32):
        raise ValueError(f"qw={qw}, qh={qh}: the kernels cover <= 32x32 "
                         "quads (64x64 codeblocks)")


def _device_of(t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device


def ht_vlc_pass(melw, vlcw, mel_lim, qws, qhs, qw: int, qh: int):
    """Quad records (N, qh, qw) int32 of the VLC pass. CPU tensors take
    ``vlc_pass_ref``; CUDA tensors launch ``csrc/ht_vlc_pass.cu``."""
    dev = _device_of(melw)
    if dev.type == "cpu":
        return vlc_pass_ref(melw, vlcw, mel_lim, qws, qhs, qw, qh)
    _check_dims(qw, qh)
    N = melw.shape[0]
    for name, t in dict(melw=melw, vlcw=vlcw, mel_lim=mel_lim, qws=qws,
                        qhs=qhs).items():
        check_tensor(t, name, torch.int32, dev, 2 if name.endswith("w")
                     else 1, N)
    rec = torch.empty((N, qh, qw), dtype=torch.int32, device=dev)
    if N == 0:
        return rec
    with torch.cuda.device(dev):
        err = build.load().lib.ht_vlc_pass_launch(
            melw.data_ptr(), melw.shape[1], vlcw.data_ptr(), vlcw.shape[1],
            mel_lim.data_ptr(), qws.data_ptr(), qhs.data_ptr(),
            _device_tables(dev).data_ptr(), N, qw, qh, rec.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "ht_vlc_pass_launch")
    ht_vlc_pass.launches += 1
    return rec


def ht_magsgn_pass(rec, msw, pLSB, maxbp, ms_lim, qws, qhs, qw: int,
                   qh: int, ms_class: int):
    """(mu, sig, ok) from the quad records. CPU tensors take
    ``magsgn_pass_ref``; CUDA tensors launch ``csrc/ht_magsgn_pass.cu``."""
    dev = _device_of(msw)
    if dev.type == "cpu":
        return magsgn_pass_ref(rec, msw, pLSB, maxbp, ms_lim, qws, qhs, qw,
                               qh, ms_class)
    _check_dims(qw, qh)
    if not 1 <= ms_class <= 32:
        raise ValueError(f"ms_class={ms_class} out of range")
    N = msw.shape[0]
    for name, t in dict(msw=msw, pLSB=pLSB, maxbp=maxbp, ms_lim=ms_lim,
                        qws=qws, qhs=qhs).items():
        check_tensor(t, name, torch.int32, dev, 2 if name == "msw" else 1,
                     N)
    check_tensor(rec, "rec", torch.int32, dev, 3, N)
    if tuple(rec.shape) != (N, qh, qw):
        raise ValueError(f"rec has shape {tuple(rec.shape)}, expected "
                         f"{(N, qh, qw)}")
    mu = torch.empty((N, 2 * qh, 2 * qw), dtype=torch.int32, device=dev)
    sig = torch.empty((N, qh, qw), dtype=torch.int32, device=dev)
    ok = torch.empty(N, dtype=torch.bool, device=dev)
    if N == 0:
        return mu, sig, ok
    with torch.cuda.device(dev):
        err = build.load().lib.ht_magsgn_pass_launch(
            rec.data_ptr(), msw.data_ptr(), msw.shape[1], pLSB.data_ptr(),
            maxbp.data_ptr(), ms_lim.data_ptr(), qws.data_ptr(),
            qhs.data_ptr(), N, qw, qh, ms_class, mu.data_ptr(),
            sig.data_ptr(), ok.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "ht_magsgn_pass_launch")
    ht_magsgn_pass.launches += 1
    return mu, sig, ok


ht_vlc_pass.launches = 0        # CUDA kernel launches
ht_magsgn_pass.launches = 0     # CUDA kernel launches


def decode_cleanup_scan_dims(msw, melw, vlcw, pLSB, maxbp, ms_lim, mel_lim,
                             qws, qhs, qw: int, qh: int, ms_class: int):
    """(mu, sig, ok) for N lanes; see the module docstring: the VLC pass,
    then the MagSgn pass on its records."""
    rec = ht_vlc_pass(melw, vlcw, mel_lim, qws, qhs, qw, qh)
    return ht_magsgn_pass(rec, msw, pLSB, maxbp, ms_lim, qws, qhs, qw, qh,
                          ms_class)


def _bucket_dims(msw, qw: int, qh: int, nreal: int, cache=None):
    """(qws, qhs) of a v2 bucket: its first `nreal` lanes decode the whole
    (qw, qh) quad grid, the pad lanes after them are inert. Both are views
    of one (2, 2n) int32 tensor on `msw`'s device, n times (qw, qh) then
    zeros, from column n - nreal; `cache` (a dict) keeps that tensor by
    (device, n, qw, qh), so that a later call takes no device operation,
    whatever its nreal."""
    n, dev = msw.shape[0], msw.device
    key = (dev, n, qw, qh)
    win = None if cache is None else cache.get(key)
    if win is None:
        a = np.zeros((2, 2 * n), np.int32)
        a[:, :n] = np.array([[qw], [qh]], np.int32)
        win = torch.from_numpy(a).to(dev)
        if cache is not None:
            cache[key] = win
    k = n - min(max(nreal, 0), n)
    return win[0, k:k + n], win[1, k:k + n]


def decode_cleanup_scan_sig(msw, melw, vlcw, pLSB, maxbp, ms_lim, mel_lim,
                            qw: int, qh: int, ms_class: int, nreal: int,
                            dims_cache=None):
    """(mu, sig, ok) of a v2 bucket, every real lane a (2qh, 2qw) codeblock
    (counterpart of ``ffmpeg_ht_tpu.ops.ht_scan.decode_cleanup_scan_sig``).
    The JAX function decodes its pad lanes (pLSB 2, maxbp 32) and masks
    their ok flag afterwards; here they are inert (qws = qhs = 0: nothing
    read, zeros out, ok true), so `ms_class` need bound the real lanes
    only. `dims_cache` keeps the lanes' (qws, qhs) (``_bucket_dims``)."""
    qws, qhs = _bucket_dims(msw, qw, qh, nreal, dims_cache)
    return decode_cleanup_scan_dims(msw, melw, vlcw, pLSB, maxbp, ms_lim,
                                    mel_lim, qws, qhs, qw, qh, ms_class)
