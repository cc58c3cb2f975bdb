"""Scalar HT (High-Throughput, Rec. ITU-T T.814) block decoder — the oracle.

Decodes one HT code-block (cleanup + optional SigProp/MagRef passes) into
sign-magnitude int32 coefficients. This is the reference model the Pallas
batch kernels are tested against (the analog of checkasm's C reference), and
the host fallback path.

Behavior parity: ff_jpeg2000_decode_htj2k and helpers
(/root/reference/libavcodec/jpeg2000htdec.c:107-1336); all bitstream
semantics follow Rec. ITU-T T.814 clauses 7.3 (cleanup: MEL, CxtVLC, U-VLC,
MagSgn), 7.4 (SigProp) and 7.5 (MagRef).

Sample order inside a quad q (n = 4q+i): i=0 top-left, 1 bottom-left,
2 top-right, 3 bottom-right (column-major 2x2), per T.814 Figure 3.
"""

from __future__ import annotations

import numpy as np

from ffmpeg_ht_tpu_torch.ops import tables as tb
from ffmpeg_ht_tpu_torch.utils.errors import InvalidData

_U32 = (1 << 32) - 1

# block_states bit positions (jpeg2000htdec.c:62-65)
_SIGMA = 0
_REF_IND = 2
_REF = 3
_SCAN = 4


class _RevBits:
    """Backward-growing bit reader with bit-unstuffing (T.814 7.3.3).

    Bits are consumed LSB-first from a little-endian buffer filled by walking
    the byte array *backwards*. A byte whose low nibble would be all-ones is
    stuffed when the byte before it (in stream order) exceeds 0x8F; the
    stuffed MSB is dropped during refill (parity: jpeg2000htdec.c:145-201).
    """

    __slots__ = ("arr", "pos", "last", "bit_buf", "bits_left")

    def __init__(self, arr, pos: int, last: int):
        self.arr = arr
        self.pos = pos
        self.last = last
        self.bit_buf = 0
        self.bits_left = 0

    def refill(self) -> None:
        a = self.arr
        self.last = a[self.pos + 1] if self.pos + 1 < len(a) else 0
        if self.bits_left >= 32:
            return
        new_bits = 32
        if self.pos >= 3:
            tmp = ((a[self.pos - 3] << 32) | (a[self.pos - 2] << 24)
                   | (a[self.pos - 1] << 16) | (a[self.pos] << 8) | self.last)
            self.pos -= 4
        else:
            tmp = 0
            if self.pos >= 2:
                tmp = a[self.pos - 2]
            if self.pos >= 1:
                tmp = (tmp << 8) | a[self.pos - 1]
            if self.pos >= 0:
                tmp = (tmp << 8) | a[self.pos]
            self.pos = 0
            tmp = (tmp << 8) | self.last
        # unstuff: drop the MSB of any byte preceded (stream order) by > 0x8F
        if (tmp & 0x7FFF000000) > 0x7F8F000000:
            tmp &= 0x7FFFFFFFFF
            new_bits -= 1
        if (tmp & 0x007FFF0000) > 0x007F8F0000:
            tmp = (tmp & 0x007FFFFFFF) + ((tmp & 0xFF00000000) >> 1)
            new_bits -= 1
        if (tmp & 0x00007FFF00) > 0x00007F8F00:
            tmp = (tmp & 0x00007FFFFF) + ((tmp & 0xFFFF000000) >> 1)
            new_bits -= 1
        if (tmp & 0x0000007FFF) > 0x0000007F8F:
            tmp = (tmp & 0x0000007FFF) + ((tmp & 0xFFFFFF0000) >> 1)
            new_bits -= 1
        tmp >>= 8
        self.bit_buf |= tmp << self.bits_left
        self.bits_left += new_bits

    def peek(self, n: int) -> int:
        return self.bit_buf & ((1 << n) - 1)

    def drop(self, n: int) -> None:
        assert self.bits_left >= n
        self.bit_buf >>= n
        self.bits_left -= n

    def get(self, n: int) -> int:
        if self.bits_left < n:
            self.refill()
        v = self.bit_buf & ((1 << n) - 1)
        self.drop(n)
        return v


class _FwdBits:
    """Forward bit reader, LSB-first, 0xFF-stuffing aware (T.814 7.3.2).

    After a 0xFF byte only 7 bits of the next byte are payload. Past the end
    of the segment, 0xFF is synthesized (jpeg2000htdec.c:207-221).
    """

    __slots__ = ("arr", "length", "pos", "last", "bit_buf", "bits_left")

    def __init__(self, arr, length: int):
        self.arr = arr
        self.length = length
        self.pos = 0
        self.last = 0
        self.bit_buf = 0
        self.bits_left = 0

    def refill(self) -> None:
        while self.bits_left < 32:
            tmp = 0xFF
            nbits = 7 if self.last == 0xFF else 8
            if self.pos < self.length:
                tmp = self.arr[self.pos]
                self.pos += 1
                self.last = tmp
            self.bit_buf |= tmp << self.bits_left
            self.bits_left += nbits

    def get(self, n: int) -> int:
        if self.bits_left <= n:
            self.refill()
        v = self.bit_buf & ((1 << n) - 1)
        self.bit_buf >>= n
        self.bits_left -= n
        return v


class _MelState:
    """MEL adaptive run-length decoder (T.814 7.3.4; jpeg2000htdec.c:462-495)."""

    __slots__ = ("k", "run", "one", "pos", "tmp", "bits", "arr", "length")

    def __init__(self, arr, pcup: int, lcup: int):
        self.k = 0
        self.run = 0
        self.one = 0
        self.arr = arr
        self.length = lcup
        self.pos = pcup
        self.tmp = 0
        self.bits = 0

    def _import_bit(self) -> int:
        cond = self.pos < self.length
        pos = min(self.pos, self.length - 1)
        if self.bits == 0:
            self.bits = 7 if self.tmp == 0xFF else 8
            self.pos += 1 if cond else 0
            self.tmp = self.arr[pos] if cond else 0xFF
        self.bits -= 1
        return (self.tmp >> self.bits) & 1

    def sym(self) -> int:
        if self.run == 0 and self.one == 0:
            eval_ = int(tb.MEL_E[self.k])
            bit = self._import_bit()
            if bit == 1:
                self.run = 1 << eval_
                self.k = min(12, self.k + 1)
            else:
                self.run = 0
                while eval_ > 0:
                    self.run = 2 * self.run + self._import_bit()
                    eval_ -= 1
                self.k = max(0, self.k - 1)
                self.one = 1
        if self.run > 0:
            self.run -= 1
            return 0
        self.one = 0
        return 1


class _SPBits:
    """Forward LSB-first bit reader used by SigProp (jpeg2000htdec.c:442-460).

    Differs from _FwdBits: byte-at-a-time, stuffed bit dropped via the 7-bit
    counter; past-the-end bytes read as 0.
    """

    __slots__ = ("arr", "length", "pos", "tmp", "last", "bits")

    def __init__(self, arr, length: int):
        self.arr = arr
        self.length = length
        self.pos = 0
        self.tmp = 0
        self.last = 0
        self.bits = 0

    def bit(self) -> int:
        if self.bits == 0:
            self.bits = 7 if self.last == 0xFF else 8
            if self.pos < self.length:
                self.tmp = self.arr[self.pos]
                self.pos += 1
            else:
                self.tmp = 0
            self.last = self.tmp
        b = self.tmp & 1
        self.tmp >>= 1
        self.bits -= 1
        return b


def _decode_ctx_vlc(vlc: _RevBits, table_idx: int, context: int):
    """One CxtVLC codeword (T.814 7.3.5; jpeg2000htdec.c:301-331)."""
    vlc.refill()
    code = vlc.peek(7)
    index = code + (context << 7)
    packed = int(tb.CXTVLC_PACKED[table_idx, index])
    vlc.drop((packed & 0xF) >> 1)
    return ((packed & 1),              # res_off
            (packed >> 4) & 0xF,       # sig_pat
            (packed >> 8) & 0xF,       # emb_pat_k
            (packed >> 12) & 0xF)      # emb_pat_1


def _u_prefix(vlc: _RevBits) -> int:
    if vlc.bits_left < 3:
        vlc.refill()
    bits = vlc.peek(3)
    vlc.drop(int(tb.UVLC_PREFIX_DROP[bits]))
    return int(tb.UVLC_PREFIX_VALUE[bits])


def _u_suffix(vlc: _RevBits, prefix: int) -> int:
    if prefix < 3:
        return 0
    if vlc.bits_left < 5:
        vlc.refill()
    bits = vlc.peek(5)
    if prefix == 3:
        vlc.drop(1)
        return bits & 1
    vlc.drop(5)
    return bits & 31


def _u_extension(vlc: _RevBits, suffix: int) -> int:
    return vlc.get(4 * (suffix >= 28))


def _decode_sig_emb(mel: _MelState, vlc: _RevBits, table_idx: int,
                    context: int):
    """MEL-gated CxtVLC decode (jpeg2000htdec.c:510-531)."""
    if context == 0:
        if mel.sym() == 0:
            return 0, 0, 0, 0
    return _decode_ctx_vlc(vlc, table_idx, context)


def _recover_mag_sgn(magsgn: _FwdBits, q: int, m4: list, emb_1: int,
                     E, mu, pLSB: int) -> None:
    """MagSgn value recovery (T.814 7.3.8; jpeg2000htdec.c:395-427)."""
    for i in range(4):
        n = 4 * q + i
        m_n = m4[i]
        known_1 = (emb_1 >> i) & 1
        if m_n > 0:
            v = magsgn.get(m_n) + (known_1 << m_n)
        else:
            v = 0
        if m_n != 0:
            E[n] = (v | 1).bit_length()
            val = ((v >> 1) + 1) << pLSB
            val |= 1 << (pLSB - 1)        # reconstruction parameter 1/2
            val |= (v & 1) << 31          # sign bit
            mu[n] = val & _U32


def decode_cleanup(data: bytes, lcup: int, pcup: int, pLSB: int, width: int,
                   height: int, maxbp: int):
    """HT cleanup segment (T.814 7.3; jpeg2000htdec.c:548-1014).

    `maxbp` bounds the U exponents: S_blk + 1, i.e. (S_blk - 1) + 2 with the
    reference's zbp mutation at jpeg2000htdec.c:1263 folded in (maxbp =
    cblk->zbp + 2 at :605 where cblk->zbp was reset to S_blk - 1).

    Returns (sample_buf, block_states), both (height+4, width+4) padded
    arrays: sample_buf u32 sign-magnitude, block_states u8 (SIGMA at bit 0,
    offset by +1,+1 like the reference).
    """
    if maxbp >= 32:
        raise InvalidData("too many bitplanes")

    qw = -(-width // 2)
    qh = -(-height // 2)
    n_quads = qw * qh

    sigma = np.zeros(4 * n_quads + 8, dtype=np.uint8)
    E = np.zeros(4 * n_quads + 8, dtype=np.uint8)
    mu = np.zeros(4 * n_quads + 8, dtype=np.uint32)

    mel = _MelState(data, pcup, lcup)
    vlc_arr = data[pcup:]
    vlc = _RevBits(vlc_arr, lcup - 2 - pcup, data[lcup - 2])
    vlc.refill()
    vlc.drop(4)
    magsgn = _FwdBits(data, pcup)
    magsgn.refill()

    def quad_u_pair_exact(res_off, initial_row: bool):
        """U-VLC for a quad pair (jpeg2000htdec.c:666-712, 828-854)."""
        u = [0, 0]
        vlc.refill()
        if res_off[0] == 1 and res_off[1] == 1:
            if initial_row:
                if mel.sym() == 1:
                    p0, p1 = _u_prefix(vlc), _u_prefix(vlc)
                    s0, s1 = _u_suffix(vlc, p0), _u_suffix(vlc, p1)
                    e0, e1 = _u_extension(vlc, s0), _u_extension(vlc, s1)
                    u[0] = 2 + p0 + s0 + 4 * e0
                    u[1] = 2 + p1 + s1 + 4 * e1
                else:
                    p0 = _u_prefix(vlc)
                    if p0 > 2:
                        u[1] = vlc.get(1) + 1
                        s0 = _u_suffix(vlc, p0)
                        e0 = _u_extension(vlc, s0)
                        u[0] = p0 + s0 + 4 * e0
                    else:
                        p1 = _u_prefix(vlc)
                        s0, s1 = _u_suffix(vlc, p0), _u_suffix(vlc, p1)
                        e0, e1 = _u_extension(vlc, s0), _u_extension(vlc, s1)
                        u[1] = p1 + s1 + 4 * e1
                        u[0] = p0 + s0 + 4 * e0
            else:
                p0, p1 = _u_prefix(vlc), _u_prefix(vlc)
                s0, s1 = _u_suffix(vlc, p0), _u_suffix(vlc, p1)
                e0, e1 = _u_extension(vlc, s0), _u_extension(vlc, s1)
                u[0] = p0 + s0 + (e0 << 2)
                u[1] = p1 + s1 + (e1 << 2)
        elif res_off[0] == 1 or res_off[1] == 1:
            pos = 0 if res_off[0] == 1 else 1
            p = _u_prefix(vlc)
            s = _u_suffix(vlc, p)
            e = _u_extension(vlc, s)
            u[pos] = p + s + (e << 2)
        return u

    # ---- initial quad row ----
    context = 0
    q = 0
    while q < qw - 1:
        q1, q2 = q, q + 1
        r1, sp1, ek1, e11 = _decode_sig_emb(mel, vlc, 0, context)
        for i in range(4):
            sigma[4 * q1 + i] = (sp1 >> i) & 1
        # int() casts: sigma is uint8 and context << 7 in _decode_ctx_vlc
        # must not wrap (jpeg2000htdec.c uses plain int context)
        context = int(sigma[4 * q1] | sigma[4 * q1 + 1]) \
            + (int(sigma[4 * q1 + 2]) << 1) + (int(sigma[4 * q1 + 3]) << 2)

        r2, sp2, ek2, e12 = _decode_sig_emb(mel, vlc, 0, context)
        for i in range(4):
            sigma[4 * q2 + i] = (sp2 >> i) & 1
        context = int(sigma[4 * q2] | sigma[4 * q2 + 1]) \
            + (int(sigma[4 * q2 + 2]) << 1) + (int(sigma[4 * q2 + 3]) << 2)

        u = quad_u_pair_exact([r1, r2], True)
        U1, U2 = 1 + u[0], 1 + u[1]
        if U1 > maxbp or U2 > maxbp:
            raise InvalidData("bad U in HT cleanup")
        m1 = [int(sigma[4 * q1 + i]) * U1 - ((ek1 >> i) & 1) for i in range(4)]
        m2 = [int(sigma[4 * q2 + i]) * U2 - ((ek2 >> i) & 1) for i in range(4)]
        _recover_mag_sgn(magsgn, q1, m1, e11, E, mu, pLSB)
        _recover_mag_sgn(magsgn, q2, m2, e12, E, mu, pLSB)
        q += 2

    if qw % 2 == 1:
        q1 = q
        r1, sp1, ek1, e11 = _decode_sig_emb(mel, vlc, 0, context)
        for i in range(4):
            sigma[4 * q1 + i] = (sp1 >> i) & 1
        u1 = 0
        if r1 == 1:
            vlc.refill()
            p = _u_prefix(vlc)
            s = _u_suffix(vlc, p)
            e = _u_extension(vlc, s)
            u1 = p + s + 4 * e
        U1 = 1 + u1
        if U1 > maxbp:
            raise InvalidData("bad U in HT cleanup")
        m1 = [int(sigma[4 * q1 + i]) * U1 - ((ek1 >> i) & 1) for i in range(4)]
        _recover_mag_sgn(magsgn, q1, m1, e11, E, mu, pLSB)
        q += 1

    # ---- non-initial quad rows ----
    def ctx_above(qq: int) -> int:
        c = int(sigma[4 * (qq - qw) + 1])            # N
        c += int(sigma[4 * (qq - qw) + 3]) << 2      # NE
        if qq % qw != 0:
            c |= int(sigma[4 * (qq - qw) - 1])       # NW
            c += (int(sigma[4 * qq - 1]) | int(sigma[4 * qq - 2])) << 1  # W
        if (qq + 1) % qw != 0:
            c |= int(sigma[4 * (qq - qw) + 5]) << 2  # NF (next above)
        return c

    def kappa_of(qq: int, sig_pat: int) -> int:
        gamma = 0 if sig_pat in (0, 1, 2, 4, 8) else 1
        e_n = int(E[4 * (qq - qw) + 1])
        e_ne = int(E[4 * (qq - qw) + 3])
        e_nw = (qq % qw != 0) * int(E[max(4 * (qq - qw) - 1, 0)])
        e_nf = ((qq + 1) % qw != 0) * int(E[4 * (qq - qw) + 5])
        max_e = max(e_nw, e_n, e_ne, e_nf)
        return max(1, gamma * (max_e - 1))

    for row in range(1, qh):
        while (q - row * qw) < qw - 1 and q < qh * qw:
            q1, q2 = q, q + 1
            c1 = ctx_above(q1)
            r1, sp1, ek1, e11 = _decode_sig_emb(mel, vlc, 1, c1)
            for i in range(4):
                sigma[4 * q1 + i] = (sp1 >> i) & 1
            c2 = ctx_above(q2)
            r2, sp2, ek2, e12 = _decode_sig_emb(mel, vlc, 1, c2)
            for i in range(4):
                sigma[4 * q2 + i] = (sp2 >> i) & 1

            u = quad_u_pair_exact([r1, r2], False)
            U1 = kappa_of(q1, sp1) + u[0]
            U2 = kappa_of(q2, sp2) + u[1]
            if U1 > maxbp or U2 > maxbp:
                raise InvalidData("bad U in HT cleanup")
            m1 = [int(sigma[4 * q1 + i]) * U1 - ((ek1 >> i) & 1) for i in range(4)]
            m2 = [int(sigma[4 * q2 + i]) * U2 - ((ek2 >> i) & 1) for i in range(4)]
            _recover_mag_sgn(magsgn, q1, m1, e11, E, mu, pLSB)
            _recover_mag_sgn(magsgn, q2, m2, e12, E, mu, pLSB)
            q += 2

        if qw % 2 == 1:
            q1 = q
            c1 = ctx_above(q1)
            r1, sp1, ek1, e11 = _decode_sig_emb(mel, vlc, 1, c1)
            for i in range(4):
                sigma[4 * q1 + i] = (sp1 >> i) & 1
            u1 = 0
            if r1 == 1:
                vlc.refill()
                p = _u_prefix(vlc)
                s = _u_suffix(vlc, p)
                e = _u_extension(vlc, s)
                u1 = p + s + (e << 2)
            U1 = kappa_of(q1, sp1) + u1
            if U1 > maxbp:
                raise InvalidData("bad U in HT cleanup")
            m1 = [int(sigma[4 * q1 + i]) * U1 - ((ek1 >> i) & 1) for i in range(4)]
            _recover_mag_sgn(magsgn, q1, m1, e11, E, mu, pLSB)
            q += 1

    # ---- quad grid -> raster (jpeg2000htdec.c:976-1007) ----
    stride = width + 4
    sample_buf = np.zeros((height + 4) * stride, dtype=np.uint32)
    block_states = np.zeros((height + 4) * stride, dtype=np.uint8)
    is_bx = width % 2
    is_by = height % 2
    idx = 0
    for y in range(qh):
        for x in range(qw):
            j1, j2 = 2 * y, 2 * x
            x1 = 1 if (y != qh - 1 or is_by == 0) else 0
            x2 = 1 if (x != qw - 1 or is_bx == 0) else 0
            x3 = x1 | x2
            sample_buf[j2 + j1 * stride] = mu[idx]
            block_states[(j1 + 1) * stride + (j2 + 1)] |= sigma[idx]
            sample_buf[j2 + (j1 + 1) * stride] = mu[idx + 1] * x1
            block_states[(j1 + 2) * stride + (j2 + 1)] |= sigma[idx + 1] * x1
            sample_buf[(j2 + 1) + j1 * stride] = mu[idx + 2] * x2
            block_states[(j1 + 1) * stride + (j2 + 2)] |= sigma[idx + 2] * x2
            sample_buf[(j2 + 1) + (j1 + 1) * stride] = mu[idx + 3] * x3
            block_states[(j1 + 2) * stride + (j2 + 2)] |= sigma[idx + 3] * x3
            idx += 4

    return sample_buf, block_states, stride


def _calc_mbr(i: int, j: int, causal_cond: int, bs, stride: int) -> int:
    """jpeg2000htdec.c:1016-1032 (i, j are sample coords; bs offset +1,+1)."""
    p0 = i * stride + j
    p1 = (i + 1) * stride + j
    p2 = (i + 2) * stride + j
    mbr0 = int(bs[p0]) | int(bs[p0 + 1]) | int(bs[p0 + 2])
    mbr1 = int(bs[p1]) | int(bs[p1 + 2])
    mbr2 = int(bs[p2]) | int(bs[p2 + 1]) | int(bs[p2 + 2])
    mbr = mbr0 | mbr1 | (mbr2 & causal_cond)
    mbr |= (mbr0 >> _REF) & (mbr0 >> _SCAN)
    mbr |= (mbr1 >> _REF) & (mbr1 >> _SCAN)
    mbr |= (mbr2 >> _REF) & (mbr2 >> _SCAN) & causal_cond
    return mbr & 1


def _process_stripes_block(sp_dec: _SPBits, i_s: int, j_s: int, width: int,
                           height: int, stride: int, pLSB: int, sample_buf,
                           bs, is_causal: int) -> None:
    """jpeg2000htdec.c:1034-1077."""
    for j in range(j_s, j_s + width):
        for i in range(i_s, i_s + height):
            causal_cond = 1 if (is_causal == 0 or i != i_s + height - 1) else 0
            sp = j + i * stride
            mbr = 0
            if (bs[(i + 1) * stride + (j + 1)] >> _SIGMA) & 1 == 0:
                mbr = _calc_mbr(i, j, causal_cond, bs, stride)
            modify = int(bs[(i + 1) * stride + (j + 1)]) | (1 << _SCAN)
            if mbr != 0:
                modify |= 1 << _REF_IND
                bit = sp_dec.bit()
                modify |= bit << _REF
                sample_buf[sp] = (int(sample_buf[sp]) | (bit << pLSB)
                                  | (bit << (pLSB - 1))) & _U32
            bs[(i + 1) * stride + (j + 1)] |= modify
    # decode signs
    for j in range(j_s, j_s + width):
        for i in range(i_s, i_s + height):
            if (bs[(i + 1) * stride + (j + 1)] >> _REF) & 1:
                bit = sp_dec.bit()
                sample_buf[j + i * stride] = \
                    (int(sample_buf[j + i * stride]) | (bit << 31)) & _U32


def decode_sigprop(dref, lref: int, width: int, height: int, stride: int,
                   pLSB: int, sample_buf, bs, is_causal: int) -> None:
    """SigProp segment (T.814 7.4; jpeg2000htdec.c:1083-1131)."""
    sp_dec = _SPBits(dref, lref)
    num_v = height // 4
    num_h = width // 4
    i = 0
    for _ in range(num_v):
        j = 0
        for _ in range(num_h):
            _process_stripes_block(sp_dec, i, j, 4, 4, stride, pLSB,
                                   sample_buf, bs, is_causal)
            j += 4
        if width % 4:
            _process_stripes_block(sp_dec, i, j, width % 4, 4, stride, pLSB,
                                   sample_buf, bs, is_causal)
        i += 4
    bh = height % 4
    j = 0
    for _ in range(num_h):
        _process_stripes_block(sp_dec, i, j, 4, bh, stride, pLSB,
                               sample_buf, bs, is_causal)
        j += 4
    if width % 4:
        _process_stripes_block(sp_dec, i, j, width % 4, bh, stride, pLSB,
                               sample_buf, bs, is_causal)


def decode_magref(dref, lref: int, width: int, height: int, stride: int,
                  pLSB: int, sample_buf, bs) -> None:
    """MagRef segment (T.814 7.5; jpeg2000htdec.c:1137-1185)."""
    mag_ref = _RevBits(dref, lref - 1, 0xFF)
    num_v = height // 4
    i_start = 0

    def refine(i: int, j: int):
        if (bs[(i + 1) * stride + (j + 1)] >> _SIGMA) & 1:
            bs[(i + 1) * stride + (j + 1)] |= 1 << _REF_IND
            bit = mag_ref.get(1)
            # int32 arithmetic of htdec.c:1162-1165: tmp = (0xFFFFFFFE|bit)
            # << pLSB, truncated to 32 bits
            t = ((0xFFFFFFFE | bit) << pLSB) & _U32
            v = int(sample_buf[i * stride + j]) & t
            v |= 1 << (pLSB - 1)
            sample_buf[i * stride + j] = v & _U32

    for _ in range(num_v):
        for j in range(width):
            for i in range(i_start, i_start + 4):
                refine(i, j)
        i_start += 4
    for j in range(width):
        for i in range(i_start, i_start + height % 4):
            refine(i, j)


def decode_htj2k(data: bytes, npasses: int, zbp: int, pass_lengths,
                 width: int, height: int, magb: int, roi_shift: int = 0,
                 is_causal: int = 0) -> np.ndarray:
    """Decode one HT code-block to sign-magnitude int32 samples.

    Parity: ff_jpeg2000_decode_htj2k (jpeg2000htdec.c:1188-1336). `magb` is
    M_b; the binary point of the result sits at bit 31 - M_b.
    Returns an (height, width) int32 array (bit 31 = sign, low bits =
    magnitude << pLSB with the +0.5 reconstruction offset applied).
    """
    if width * height == 0:
        return np.zeros((height, width), dtype=np.int32)
    assert width <= 1024 and height <= 1024 and width * height <= 4096

    out = np.zeros((height, width), dtype=np.int32)
    if npasses == 0:
        return out

    num_rempass = npasses % 3
    num_plhd = npasses - num_rempass if num_rempass else npasses - 3
    p0 = num_plhd // 3
    z_blk = npasses - num_plhd
    if z_blk <= 0:
        return out

    lcup = pass_lengths[0]
    lref = pass_lengths[1]
    if lcup < 2:
        raise InvalidData("cleanup pass length < 2")

    buf = bytearray(data)
    needed = lcup + lref + 1
    if len(buf) < needed:
        buf.extend(b"\x00" * (needed - len(buf)))
    buf[lcup + lref] = 0xFF  # extra trailing byte for Dref (htdec.c:1260)

    s_blk = p0 + zbp
    pLSB = 30 - s_blk

    scup = (buf[lcup - 1] << 4) + (buf[lcup - 2] & 0x0F)
    if scup < 2 or scup > lcup or scup > 4079:
        raise InvalidData(f"invalid Scup {scup}")
    pcup = lcup - scup

    # modDcup (htdec.c:1277-1278)
    buf[lcup - 1] = 0xFF
    buf[lcup - 2] |= 0x0F

    if s_blk + 1 < 32:
        # native tier (native/htdec.c): the same algorithm at C speed —
        # host-fallback lanes cost ~20 ms/block in Python on this host
        from ffmpeg_ht_tpu_torch.utils import native as NV
        nat = NV.ht_decode_block(buf, lcup, pcup, lref, pLSB, width,
                                 height, s_blk + 1, magb, roi_shift,
                                 z_blk, is_causal)
        if nat is not None:
            return nat

    sample_buf, block_states, stride = decode_cleanup(
        bytes(buf), lcup, pcup, pLSB, width, height, s_blk + 1)

    dref = bytes(buf[lcup:])
    if z_blk > 1:
        decode_sigprop(dref, lref, width, height, stride, pLSB - 1,
                       sample_buf, block_states, is_causal)
    if z_blk > 2:
        decode_magref(dref, lref, width, height, stride, pLSB - 1,
                      sample_buf, block_states)

    # final writeback with ROI upshift (htdec.c:1317-1331)
    mask = _U32 >> (magb + 1)
    vals = sample_buf[:height * stride].reshape(height, stride)[:, :width]
    vals = vals.astype(np.int64)
    sign = vals & 0x80000000
    mag = vals & 0x7FFFFFFF
    if roi_shift:
        roi = (mag & ~mask & 0x7FFFFFFF) == 0
        mag = np.where(roi, (mag << roi_shift) & 0x7FFFFFFF, mag)
    out = (mag | sign).astype(np.uint32).view(np.int32).reshape(height, width)
    return out.copy()
