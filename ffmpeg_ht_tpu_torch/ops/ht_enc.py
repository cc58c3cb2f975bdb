"""HT (High-Throughput, Rec. ITU-T T.814) block encoder — cleanup pass.

The reference has no HT encoder (ffmpeg only decodes HT); this module is
the capability the test strategy needs: it generates HTJ2K codestreams that
both this package's decoder (ops/ht_dec.py) and the reference `ffmpeg`
HT decoder accept, giving a two-decoder cross-check for every HT test.

The encoder emits a single cleanup pass (z_blk = 1) carrying all magnitude
bitplanes: MEL run-length coding of quad significance, CxtVLC significance/
EMB patterns, U-VLC exponent offsets and a MagSgn magnitude/sign stream,
assembled per T.814 7.2/7.3 (stream layout as consumed by
jpeg2000htdec.c:1188-1336).

Interop constraint: the reference discards samples coded with m_n == 0
(recover_mag_sgn, jpeg2000htdec.c:419-426 skips mu when m_n == 0), so the
encoder keeps m_n >= 1 for every significant sample by bounding U_q >= 2
and only using EMB entries consistent with that.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ffmpeg_ht_tpu_torch.ops import tables as tb
from ffmpeg_ht_tpu_torch.utils.errors import InvalidData


# ---------------------------------------------------------------------------
# bit packers (each is the exact inverse of a reader in ops/ht_dec.py)
# ---------------------------------------------------------------------------

class MagSgnPacker:
    """Forward LSB-first packer; a byte following 0xFF holds 7 payload bits
    (inverse of ht_dec._FwdBits)."""

    def __init__(self):
        self.bytes = bytearray()
        self.cur = 0
        self.nbits = 0
        self.cap = 8

    def _close(self):
        self.bytes.append(self.cur)
        self.cap = 7 if self.cur == 0xFF else 8
        self.cur = 0
        self.nbits = 0

    def put(self, val: int, n: int) -> None:
        for i in range(n):
            self.cur |= ((val >> i) & 1) << self.nbits
            self.nbits += 1
            if self.nbits == self.cap:
                self._close()

    def finish(self) -> bytes:
        if self.nbits:
            self._close()
        return bytes(self.bytes)


class MELPacker:
    """MEL adaptive run-length encoder (inverse of ht_dec._MelState).

    Bits are MSB-first within a byte; a byte following 0xFF holds 7 bits.
    """

    def __init__(self):
        self.k = 0
        self.run = 0
        self.bytes = bytearray()
        self.cur = 0
        self.nbits = 0
        self.cap = 8

    def _bit(self, b: int) -> None:
        self.cur |= b << (self.cap - 1 - self.nbits)
        self.nbits += 1
        if self.nbits == self.cap:
            self.bytes.append(self.cur)
            self.cap = 7 if self.cur == 0xFF else 8
            self.cur = 0
            self.nbits = 0

    def sym(self, s: int) -> None:
        eval_ = int(tb.MEL_E[self.k])
        if s == 0:
            self.run += 1
            if self.run == (1 << eval_):
                self._bit(1)
                self.run = 0
                self.k = min(12, self.k + 1)
        else:
            self._bit(0)
            for i in range(eval_ - 1, -1, -1):
                self._bit((self.run >> i) & 1)
            self.run = 0
            self.k = max(0, self.k - 1)

    def finish(self) -> bytes:
        if self.run > 0:
            # flush a pending zero-run as a completed run; the decoder
            # produces >= run zeros of which only `run` are consumed
            self._bit(1)
        if self.nbits:
            self.bytes.append(self.cur)
            self.cur = 0
            self.nbits = 0
        return bytes(self.bytes)


class RevPacker:
    """Backward-growing bit packer for the MagRef segment.

    Same unstuffing rule as VLCPacker but with no Scup nibble: the MagRef
    reader starts at the last Dref byte whose successor is the forced
    0xFF byte (ht_dec.decode_magref / jpeg2000htdec.c:1137-1185)."""

    def __init__(self):
        self.bytes = []
        self.cur = 0
        self.nbits = 0
        self.prev = 0xFF  # forced trailing 0xFF beyond Dref

    def _full(self) -> bool:
        if self.nbits == 7:
            return self.prev > 0x8F and (self.cur & 0x7F) == 0x7F
        return self.nbits == 8

    def bit(self, b: int) -> None:
        self.cur |= b << self.nbits
        self.nbits += 1
        if self._full():
            self.bytes.append(self.cur)
            self.prev = self.cur
            self.cur = 0
            self.nbits = 0

    def finish(self) -> bytes:
        if self.nbits > 0:
            self.bytes.append(self.cur)
            self.cur = 0
            self.nbits = 0
        return bytes(reversed(self.bytes))


class VLCPacker:
    """Backward-growing VLC packer (inverse of ht_dec._RevBits).

    Bits are collected LSB-first into bytes in decoder *reading* order
    (which is reverse address order); `finish` returns the bytes in address
    order ready to append after the MEL segment. Bit-unstuffing parity:
    the decoder drops the MSB of a byte whose low 7 bits are all ones when
    the previously-read byte (higher address) exceeds 0x8F
    (ht_dec._RevBits.refill); the first byte's low nibble is the Scup low
    nibble which the decoder forces to 0xF (modDcup), and its predecessor
    is the forced 0xFF trailer byte.
    """

    def __init__(self):
        self.bytes = []       # in reading order; byte 0 low nibble reserved
        self.cur = 0x0F       # placeholder low nibble (modDcup view)
        self.nbits = 4
        self.prev = 0xFF      # modDcup trailer byte precedes byte 0

    def _full(self) -> bool:
        if self.nbits == 7:
            return self.prev > 0x8F and (self.cur & 0x7F) == 0x7F
        return self.nbits == 8

    def bit(self, b: int) -> None:
        self.cur |= b << self.nbits
        self.nbits += 1
        if self._full():
            self.bytes.append(self.cur)
            self.prev = self.cur
            self.cur = 0
            self.nbits = 0

    def put(self, val: int, n: int) -> None:
        for i in range(n):
            self.bit((val >> i) & 1)

    def finish(self) -> tuple:
        """Returns (payload bytes in address order, scup_low_nibble_mask).

        The first reading-order byte's low nibble must be OR-ed with the
        Scup low nibble by the caller (we emitted it as 0xF placeholder;
        clear it here so the caller can OR the real value in).
        """
        if self.nbits > 0 or not self.bytes:
            self.bytes.append(self.cur)
            self.cur = 0
            self.nbits = 0
        out = list(self.bytes)
        out[0] &= 0xF0  # clear the Scup placeholder nibble
        return bytes(reversed(out))


# ---------------------------------------------------------------------------
# inverse CxtVLC tables
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _inverse_cxtvlc(table_idx: int):
    """(ctx, res_off, sig_pat, emb_k, emb_1) -> (codeword, length)."""
    inv = {}
    for ctx in range(8):
        for code in range(128):
            packed = int(tb.CXTVLC_PACKED[table_idx, code + (ctx << 7)])
            if packed == 0:
                continue
            length = (packed & 0xF) >> 1
            if length == 0 or length > 7:
                continue
            cwd = code & ((1 << length) - 1)
            key = (ctx, packed & 1, (packed >> 4) & 0xF,
                   (packed >> 8) & 0xF, (packed >> 12) & 0xF)
            if key not in inv:
                inv[key] = (cwd, length)
    return inv


# ---------------------------------------------------------------------------
# U-VLC encode (inverse of ht_dec._u_prefix/_u_suffix/_u_extension)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _uvlc_prefix_codes():
    """prefix value -> (bits, nbits), derived by inverting the decoder LUT."""
    codes = {}
    for bits in range(8):
        val = int(tb.UVLC_PREFIX_VALUE[bits])
        drop = int(tb.UVLC_PREFIX_DROP[bits])
        key = val
        if key not in codes:
            codes[key] = (bits & ((1 << drop) - 1), drop)
    return codes


def _uvlc_parts(u: int):
    """Split u (>=1) into (prefix, suffix, extension) bit fields.

    Mirrors the decoder's read structure (_u_prefix/_u_suffix/_u_extension):
    prefix in {1,2,3,5}; 1-bit suffix for prefix 3; 5-bit suffix (+4-bit
    extension when suffix >= 28) for prefix 5.
    """
    pcodes = _uvlc_prefix_codes()
    if u <= 2:
        return [pcodes[u], (0, 0), (0, 0)]
    if u <= 4:
        return [pcodes[3], (u - 3, 1), (0, 0)]
    s = u - 5
    if s < 28:
        return [pcodes[5], (s, 5), (0, 0)]
    s_field = 28 + (s % 4)
    ext = (s - s_field) >> 2
    if not 0 <= ext <= 15:
        raise InvalidData(f"u={u} not encodable")
    return [pcodes[5], (s_field, 5), (ext, 4)]


def _put_uvlc(vlc: VLCPacker, u: int) -> None:
    """Emit one u value contiguously (single-quad read order)."""
    for val, n in _uvlc_parts(u):
        vlc.put(val, n)


def _put_uvlc_pair(vlc: VLCPacker, u1: int, u2: int) -> None:
    """Emit a u pair in the decoder's interleaved read order:
    prefix1, prefix2, suffix1, suffix2, ext1, ext2
    (ht_dec.quad_u_pair_exact / jpeg2000htdec.c:666-712)."""
    a = _uvlc_parts(u1)
    b = _uvlc_parts(u2)
    for part in range(3):
        vlc.put(*a[part])
        vlc.put(*b[part])


# ---------------------------------------------------------------------------
# cleanup-segment encoder
# ---------------------------------------------------------------------------

def _quad_layout(mag, sign, width, height):
    """Per-quad sigma/v/E arrays in the decoder's quad order."""
    qw = -(-width // 2)
    qh = -(-height // 2)
    n = 4 * qw * qh + 8
    sigma = np.zeros(n, dtype=np.uint8)
    v = np.zeros(n, dtype=np.int64)
    E = np.zeros(n, dtype=np.uint8)
    for qy in range(qh):
        for qx in range(qw):
            q = qy * qw + qx
            for i in range(4):
                x = 2 * qx + (i >> 1)
                y = 2 * qy + (i & 1)
                if x >= width or y >= height:
                    continue
                m = int(mag[y, x])
                if m == 0:
                    continue
                idx = 4 * q + i
                sigma[idx] = 1
                v[idx] = 2 * (m - 1) + int(sign[y, x])
                E[idx] = int(v[idx] | 1).bit_length()
    return qw, qh, sigma, v, E


def _pick_entry(inv, ctx, rho, u_off, U, v, E, base):
    """Choose a CxtVLC entry consistent with the decoder's reconstruction.

    Feasibility for significant sample i (see module docstring):
      emb_k_i == 0: always fine (m = U >= 1 bits carry v fully, E_i <= U)
      emb_k_i == 1: needs U >= 2 and (v_i >> (U-1)) == emb_1_i
    Returns (cwd, len, emb_k) minimizing MagSgn bits.
    """
    best = None
    for (c, r, sp, ek, e1), (cwd, ln) in inv.items():
        if c != ctx or r != u_off or sp != rho:
            continue
        ok = True
        for i in range(4):
            if not (rho >> i) & 1:
                if (ek >> i) & 1:
                    ok = False
                    break
                continue
            if (ek >> i) & 1:
                if U < 2 or (int(v[base + i]) >> (U - 1)) != ((e1 >> i) & 1):
                    ok = False
                    break
            else:
                if int(E[base + i]) > U:
                    ok = False
                    break
        if not ok:
            continue
        cost = bin(ek & rho).count("1")  # more known MSBs -> fewer bits
        if best is None or cost > best[0] or (cost == best[0]
                                              and ln < best[2]):
            best = (cost, cwd, ln, ek)
    if best is None:
        return None
    return best[1], best[2], best[3]


def encode_cleanup(mag: np.ndarray, sign: np.ndarray, zbp: int):
    """Encode one code-block's cleanup segment.

    `mag` (h, w) non-negative quantized magnitudes, `sign` (h, w) 0/1.
    Returns the Dcup byte string (MagSgn || MEL || reversed VLC || Scup
    trailer) and Lcup. The caller signals `zbp` zero bitplanes via the
    packet header; the decoder's U bound is maxbp = zbp + 1 (parity:
    jpeg2000htdec.c:605,1263).
    """
    height, width = mag.shape

    from ffmpeg_ht_tpu_torch.utils import native
    res = native.ht_encode_cleanup(np.asarray(mag), np.asarray(sign), zbp)
    if res is not None:
        return res

    qw, qh, sigma, v, E = _quad_layout(mag, sign, width, height)
    maxbp = zbp + 1

    mel = MELPacker()
    vlc = VLCPacker()
    magsgn = MagSgnPacker()
    inv0 = _inverse_cxtvlc(0)
    inv1 = _inverse_cxtvlc(1)

    def emit_magsgn(q, U, ek):
        for i in range(4):
            idx = 4 * q + i
            if not sigma[idx]:
                continue
            m_n = U - ((ek >> i) & 1)
            magsgn.put(int(v[idx]), m_n)

    def quad_U(q):
        """Canonical U for quad q: max exponent (0 if insignificant).

        m_n >= 1 (ffmpeg interop, see module docstring) is enforced by
        _pick_entry rejecting emb_k=1 entries when U < 2; emb_k=0 entries
        always give m_n = U >= 1.
        """
        es = [int(E[4 * q + i]) for i in range(4) if sigma[4 * q + i]]
        return max(es) if es else 0

    def rho_of(q):
        return (int(sigma[4 * q]) | (int(sigma[4 * q + 1]) << 1)
                | (int(sigma[4 * q + 2]) << 2) | (int(sigma[4 * q + 3]) << 3))

    def encode_quad(q, tbl_inv, ctx, kappa, initial):
        """VLC+MEL for one quad; returns (u, ek, U)."""
        rho = rho_of(q)
        if ctx == 0:
            mel.sym(1 if rho else 0)
            if rho == 0:
                return 0, 0, 0
        U = max(quad_U(q), kappa) if rho else 0
        if rho == 0:
            # significant-pattern 0 with nonzero context still needs a
            # VLC codeword (decoder always reads one when ctx != 0)
            ent = _pick_entry(tbl_inv, ctx, 0, 0, 0, v, E, 4 * q)
            if ent is None:
                raise InvalidData(f"no CxtVLC entry ctx={ctx} rho=0")
            cwd, ln, ek = ent
            vlc.put(cwd, ln)
            return 0, 0, 0
        u = U - kappa
        u_off = 1 if u > 0 else 0
        ent = _pick_entry(tbl_inv, ctx, rho, u_off, U, v, E, 4 * q)
        if ent is None:
            # fallback: raise U by one so all emb_k=0 entries become
            # feasible (magnitudes sent fully explicit)
            U += 1
            u = U - kappa
            u_off = 1
            ent = _pick_entry(tbl_inv, ctx, rho, u_off, U, v, E, 4 * q)
        if ent is None:
            raise InvalidData(
                f"no CxtVLC entry ctx={ctx} rho={rho:x} u_off={u_off}")
        if U > maxbp:
            raise InvalidData(f"U={U} exceeds bound {maxbp}: zbp too small")
        cwd, ln, ek = ent
        vlc.put(cwd, ln)
        return u, ek, U

    # --- initial quad row (decoder: ht_dec.decode_cleanup row 0) ---
    context = 0
    q = 0
    while q < qw - 1:
        u1, ek1, U1 = encode_quad(q, inv0, context, 1, True)
        context = ((sigma[4 * q] | sigma[4 * q + 1])
                   + (sigma[4 * q + 2] << 1) + (sigma[4 * q + 3] << 2))
        u2, ek2, U2 = encode_quad(q + 1, inv0, context, 1, True)
        context = ((sigma[4 * q + 4] | sigma[4 * q + 5])
                   + (sigma[4 * q + 6] << 1) + (sigma[4 * q + 7] << 2))
        # joint u coding (decoder quad_u_pair_exact, initial_row=True)
        if u1 > 0 and u2 > 0:
            if u1 >= 3 and u2 >= 3:
                mel.sym(1)
                _put_uvlc_pair(vlc, u1 - 2, u2 - 2)
            elif u1 >= 3:
                # decoder branch p0 > 2: prefix(u1), 1 bit (u2-1),
                # suffix(u1), ext(u1)  (ht_dec.quad_u_pair_exact)
                mel.sym(0)
                a = _uvlc_parts(u1)
                vlc.put(*a[0])
                vlc.put(u2 - 1, 1)
                vlc.put(*a[1])
                vlc.put(*a[2])
            else:
                # u1 <= 2: its suffix/ext are empty, so interleaved order
                # degenerates to prefix1, prefix2, suffix2, ext2
                mel.sym(0)
                _put_uvlc_pair(vlc, u1, u2)
        elif u1 > 0:
            _put_uvlc(vlc, u1)
        elif u2 > 0:
            _put_uvlc(vlc, u2)
        emit_magsgn(q, U1, ek1)
        emit_magsgn(q + 1, U2, ek2)
        q += 2
    if qw % 2 == 1:
        u1, ek1, U1 = encode_quad(q, inv0, context, 1, True)
        if u1 > 0:
            _put_uvlc(vlc, u1)
        emit_magsgn(q, U1, ek1)
        q += 1

    # --- non-initial rows ---
    def ctx_above(qq):
        c = int(sigma[4 * (qq - qw) + 1])
        c += int(sigma[4 * (qq - qw) + 3]) << 2
        if qq % qw != 0:
            c |= int(sigma[4 * (qq - qw) - 1])
            c += (int(sigma[4 * qq - 1]) | int(sigma[4 * qq - 2])) << 1
        if (qq + 1) % qw != 0:
            c |= int(sigma[4 * (qq - qw) + 5]) << 2
        return c

    def kappa_of(qq):
        rho = rho_of(qq)
        gamma = 0 if rho in (0, 1, 2, 4, 8) else 1
        e_n = int(E[4 * (qq - qw) + 1])
        e_ne = int(E[4 * (qq - qw) + 3])
        e_nw = (qq % qw != 0) * int(E[max(4 * (qq - qw) - 1, 0)])
        e_nf = ((qq + 1) % qw != 0) * int(E[4 * (qq - qw) + 5])
        return max(1, gamma * (max(e_nw, e_n, e_ne, e_nf) - 1))

    for row in range(1, qh):
        while (q - row * qw) < qw - 1 and q < qh * qw:
            c1 = ctx_above(q)
            u1, ek1, U1 = encode_quad(q, inv1, c1, kappa_of(q), False)
            c2 = ctx_above(q + 1)
            u2, ek2, U2 = encode_quad(q + 1, inv1, c2, kappa_of(q + 1), False)
            if u1 > 0 and u2 > 0:
                _put_uvlc_pair(vlc, u1, u2)
            elif u1 > 0:
                _put_uvlc(vlc, u1)
            elif u2 > 0:
                _put_uvlc(vlc, u2)
            emit_magsgn(q, U1, ek1)
            emit_magsgn(q + 1, U2, ek2)
            q += 2
        if qw % 2 == 1:
            c1 = ctx_above(q)
            u1, ek1, U1 = encode_quad(q, inv1, c1, kappa_of(q), False)
            if u1 > 0:
                _put_uvlc(vlc, u1)
            emit_magsgn(q, U1, ek1)
            q += 1

    # --- assemble Dcup (jpeg2000htdec.c:1266-1293 layout) ---
    ms = magsgn.finish()
    melb = mel.finish()
    vlcb = vlc.finish()  # includes the byte at Lcup-2 (reading-order byte 0)
    pcup = len(ms)
    scup = len(melb) + len(vlcb) + 1  # + the final Scup-high trailer byte
    if scup < 2 or scup > 4079:
        raise InvalidData(f"Scup {scup} out of range")
    body = bytearray(ms + melb + vlcb)
    # trailer: byte Lcup-2 low nibble = Scup & 0xF (merged into the last
    # VLC byte), byte Lcup-1 = Scup >> 4
    body[-1] |= scup & 0xF
    body.append(scup >> 4)
    lcup = len(body)
    assert lcup == pcup + scup
    return bytes(body), lcup


# ---------------------------------------------------------------------------
# SigProp / MagRef encoding (refinement segment, T.814 7.4/7.5)
# ---------------------------------------------------------------------------

def _encode_stripes_block(sp: MagSgnPacker, i_s, j_s, width, height, stride,
                          sample_buf, bs, mag, sign, is_causal):
    """Mirror of ht_dec._process_stripes_block, emitting bits instead of
    reading them. Newly-significant samples carry |c| == 1."""
    from ffmpeg_ht_tpu_torch.ops.ht_dec import _REF, _REF_IND, _SCAN, _SIGMA, _calc_mbr
    for j in range(j_s, j_s + width):
        for i in range(i_s, i_s + height):
            causal_cond = 1 if (is_causal == 0 or i != i_s + height - 1) else 0
            mbr = 0
            if (bs[(i + 1) * stride + (j + 1)] >> _SIGMA) & 1 == 0:
                mbr = _calc_mbr(i, j, causal_cond, bs, stride)
            modify = int(bs[(i + 1) * stride + (j + 1)]) | (1 << _SCAN)
            if mbr != 0:
                bit = int(mag[i, j]) & 1  # cleanup-insignificant => |c|<=1
                sp.put(bit, 1)
                modify |= 1 << _REF_IND
                modify |= bit << _REF
            bs[(i + 1) * stride + (j + 1)] |= modify
    for j in range(j_s, j_s + width):
        for i in range(i_s, i_s + height):
            if (bs[(i + 1) * stride + (j + 1)] >> _REF) & 1:
                sp.put(int(sign[i, j]), 1)


def encode_sigprop(sp: MagSgnPacker, width, height, stride, sample_buf, bs,
                   mag, sign, is_causal=0) -> None:
    """Mirror of ht_dec.decode_sigprop (stripe scan driver)."""
    num_v = height // 4
    num_h = width // 4
    i = 0
    for _ in range(num_v):
        j = 0
        for _ in range(num_h):
            _encode_stripes_block(sp, i, j, 4, 4, stride, sample_buf, bs,
                                  mag, sign, is_causal)
            j += 4
        if width % 4:
            _encode_stripes_block(sp, i, j, width % 4, 4, stride,
                                  sample_buf, bs, mag, sign, is_causal)
        i += 4
    bh = height % 4
    j = 0
    for _ in range(num_h):
        _encode_stripes_block(sp, i, j, 4, bh, stride, sample_buf, bs,
                              mag, sign, is_causal)
        j += 4
    if width % 4:
        _encode_stripes_block(sp, i, j, width % 4, bh, stride, sample_buf,
                              bs, mag, sign, is_causal)


def encode_magref(mr: RevPacker, width, height, stride, bs, mag) -> None:
    """Mirror of ht_dec.decode_magref: LSB of every cleanup-significant
    sample, in the 4-row stripe column scan order."""
    from ffmpeg_ht_tpu_torch.ops.ht_dec import _SIGMA
    num_v = height // 4
    i_start = 0
    for _ in range(num_v):
        for j in range(width):
            for i in range(i_start, i_start + 4):
                if (bs[(i + 1) * stride + (j + 1)] >> _SIGMA) & 1:
                    mr.bit(int(mag[i, j]) & 1)
        i_start += 4
    for j in range(width):
        for i in range(i_start, i_start + height % 4):
            if (bs[(i + 1) * stride + (j + 1)] >> _SIGMA) & 1:
                mr.bit(int(mag[i, j]) & 1)


def encode_block_3pass(mag: np.ndarray, sign: np.ndarray, zbp: int,
                       is_causal: int = 0):
    """Encode one code-block as Cleanup + SigProp + MagRef (z_blk = 3).

    The cleanup pass carries |c| >> 1 (all magnitude planes but the
    finest); SigProp adds significance at the finest plane for samples
    with |c| == 1; MagRef refines the LSB of cleanup-significant samples.
    Returns (data = Dcup||Dref, lcup, lref). Signal npasses = 3 and
    zero-bitplanes = zbp where the decoder's pLSB = 30 - zbp positions
    the cleanup LSB one plane above the dequant LSB (see
    models/encoder.encode_frame_htj2k refinement mode).
    """
    from ffmpeg_ht_tpu_torch.ops import ht_dec

    height, width = mag.shape
    coarse = mag >> 1
    dcup, lcup = encode_cleanup(coarse, np.where(coarse > 0, sign, 0), zbp)

    # run the cleanup decoder to obtain the exact block state the
    # refinement passes start from (sample_buf / block_states)
    buf = bytearray(dcup)
    scup = (buf[lcup - 1] << 4) + (buf[lcup - 2] & 0x0F)
    buf[lcup - 1] = 0xFF
    buf[lcup - 2] |= 0x0F
    pLSB = 30 - zbp
    sample_buf, bs, stride = ht_dec.decode_cleanup(
        bytes(buf), lcup, lcup - scup, pLSB, width, height, zbp + 1)

    sp = MagSgnPacker()
    encode_sigprop(sp, width, height, stride, sample_buf, bs, mag, sign,
                   is_causal)

    # SigProp can only signal samples inside the MBR neighborhood of the
    # cleanup significance map (jpeg2000htdec.c:1016-1032). An isolated
    # |c| == 1 sample is unreachable; such blocks must carry the finest
    # plane in the cleanup instead (caller falls back on None).
    from ffmpeg_ht_tpu_torch.ops.ht_dec import _REF
    bs2 = bs.reshape(height + 4, stride)
    ref = (bs2[1:height + 1, 1:width + 1] >> _REF) & 1
    need = (mag == 1)
    if np.any(need & (ref == 0)):
        return None

    mr = RevPacker()
    encode_magref(mr, width, height, stride, bs, mag)
    dref = sp.finish() + mr.finish()
    return dcup + dref, lcup, len(dref)
