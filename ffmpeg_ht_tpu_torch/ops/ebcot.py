"""Legacy EBCOT Tier-1 decoder (ISO 15444-1, MQ arithmetic coder).

Needed for plain JPEG 2000 codestreams and HT-MIXED blocks. Behavior parity:
mqcdec.c (MQ decoder), decode_sigpass/refpass/clnpass and decode_cblk
(jpeg2000dec.c:1872-2089). Output matches the HT path's convention:
sign-magnitude int32 with binary point at 31 - M_b.
"""

from __future__ import annotations

import numpy as np

from ffmpeg_ht_tpu_torch.ops import tables as tb
from ffmpeg_ht_tpu_torch.utils.errors import InvalidData

# T1 flag bits (jpeg2000.h:84-108)
SIG_N, SIG_E, SIG_W, SIG_S = 0x0001, 0x0002, 0x0004, 0x0008
SIG_NE, SIG_NW, SIG_SE, SIG_SW = 0x0010, 0x0020, 0x0040, 0x0080
SIG_NB = 0x00FF
SGN_N, SGN_S, SGN_W, SGN_E = 0x0100, 0x0200, 0x0400, 0x0800
VIS, SIG, REF = 0x1000, 0x2000, 0x4000


def _build_sigctx_lut() -> np.ndarray:
    """Significance-context LUT (jpeg2000.c:96-139)."""
    lut = np.zeros((256, 4), dtype=np.uint8)
    for flag in range(256):
        h = bool(flag & SIG_E) + bool(flag & SIG_W)
        v = bool(flag & SIG_N) + bool(flag & SIG_S)
        d = (bool(flag & SIG_NE) + bool(flag & SIG_NW)
             + bool(flag & SIG_SE) + bool(flag & SIG_SW))
        for bandno in range(4):
            hh, vv = (v, h) if bandno == 1 else (h, v)
            if bandno < 3:
                if hh == 2:
                    c = 8
                elif hh == 1:
                    c = 7 if vv >= 1 else (6 if d >= 1 else 5)
                elif vv == 2:
                    c = 4
                elif vv == 1:
                    c = 3
                elif d >= 2:
                    c = 2
                elif d == 1:
                    c = 1
                else:
                    c = 0
            else:
                if d >= 3:
                    c = 8
                elif d == 2:
                    c = 7 if hh + vv >= 1 else 6
                elif d == 1:
                    c = 5 if hh + vv >= 2 else (4 if hh + vv == 1 else 3)
                elif hh + vv >= 2:
                    c = 2
                elif hh + vv == 1:
                    c = 1
                else:
                    c = 0
            lut[flag, bandno] = c
    return lut


def _build_sgnctx_luts():
    """Sign-context and xor-bit LUTs (jpeg2000.c:141-158)."""
    contrib = [[0, -1, 1], [-1, -1, 0], [1, 0, 1]]
    ctxlbl = [[13, 12, 11], [10, 9, 10], [11, 12, 13]]
    xorbit = [[1, 1, 1], [1, 0, 0], [0, 0, 0]]
    sgn = np.zeros((16, 16), dtype=np.uint8)
    xor = np.zeros((16, 16), dtype=np.uint8)
    for i in range(16):
        for j in range(16):
            flag = i + (j << 8)

            def sel(fsig, fsgn):
                if flag & fsig:
                    return 1 if flag & fsgn else 2
                return 0

            h = contrib[sel(SIG_E, SGN_E)][sel(SIG_W, SGN_W)] + 1
            v = contrib[sel(SIG_S, SGN_S)][sel(SIG_N, SGN_N)] + 1
            sgn[i, j] = ctxlbl[h][v]
            xor[i, j] = xorbit[h][v]
    return sgn, xor


SIGCTX_LUT = _build_sigctx_lut()
SGNCTX_LUT, XORBIT_LUT = _build_sgnctx_luts()
REFCTX_LUT = np.array([[14, 15], [16, 16]], dtype=np.uint8)


class MQDecoder:
    """MQ arithmetic decoder (mqcdec.c parity)."""

    __slots__ = ("data", "bp", "a", "c", "raw", "cx_states")

    def __init__(self, data, bp: int = 0, raw: bool = False,
                 reset: bool = True, cx_states=None):
        self.data = data
        self.raw = raw
        self.cx_states = (tb.mq_initial_cx_states() if reset or cx_states is None
                          else cx_states)
        self.bp = bp
        self.c = (self.data[self.bp] ^ 0xFF) << 16
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.a = 0x8000

    def reinit(self, bp: int, raw: bool, reset: bool) -> None:
        self.raw = raw
        if reset:
            self.cx_states = tb.mq_initial_cx_states()
        self.bp = bp
        self.c = (self.data[self.bp] ^ 0xFF) << 16
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.a = 0x8000

    def _byte(self, i: int) -> int:
        return self.data[i] if i < len(self.data) else 0xFF

    def _bytein(self) -> None:
        if self._byte(self.bp) == 0xFF:
            if self._byte(self.bp + 1) > 0x8F:
                self.c += 1
            else:
                self.bp += 1
                self.c += 2 + 0xFE00 - (self._byte(self.bp) << 9)
        else:
            self.bp += 1
            self.c += 1 + 0xFF00 - (self._byte(self.bp) << 8)
        self.c &= 0xFFFFFFFF

    def _exchange(self, cx: int, lps: int) -> int:
        state = self.cx_states[cx]
        qe = int(tb.MQ_QE[state])
        if (self.a < qe) ^ (not lps):
            if lps:
                self.a = qe
            d = int(state & 1)
            self.cx_states[cx] = tb.MQ_NMPS[state]
        else:
            if lps:
                self.a = qe
            d = 1 - int(state & 1)
            self.cx_states[cx] = tb.MQ_NLPS[state]
        # RENORMD
        while True:
            if not (self.c & 0xFF):
                self.c -= 0x100
                self._bytein()
            self.a = (self.a + self.a) & 0xFFFFFFFF
            self.c = (self.c + self.c) & 0xFFFFFFFF
            if self.a & 0x8000:
                break
        return d

    def _decode_bypass(self) -> int:
        bit = 0 if (self.c & 0x40000000) else 1
        if not (self.c & 0xFF):
            self.c -= 0x100
            self._bytein()
        self.c = (self.c + self.c) & 0xFFFFFFFF
        return bit

    def decode(self, cx: int) -> int:
        if self.raw:
            return self._decode_bypass()
        state = self.cx_states[cx]
        self.a -= int(tb.MQ_QE[state])
        if (self.c >> 16) < self.a:
            if self.a & 0x8000:
                return int(state & 1)
            return self._exchange(cx, 0)
        self.c = (self.c - (self.a << 16)) & 0xFFFFFFFF
        return self._exchange(cx, 1)


def _set_significance(flags, stride: int, x: int, y: int, negative: bool):
    """ff_jpeg2000_set_significance (jpeg2000.c:178-199)."""
    x += 1
    y += 1
    flags[y * stride + x] |= SIG
    if negative:
        flags[y * stride + x + 1] |= SIG_W | SGN_W
        flags[y * stride + x - 1] |= SIG_E | SGN_E
        flags[(y + 1) * stride + x] |= SIG_N | SGN_N
        flags[(y - 1) * stride + x] |= SIG_S | SGN_S
    else:
        flags[y * stride + x + 1] |= SIG_W
        flags[y * stride + x - 1] |= SIG_E
        flags[(y + 1) * stride + x] |= SIG_N
        flags[(y - 1) * stride + x] |= SIG_S
    flags[(y + 1) * stride + x + 1] |= SIG_NW
    flags[(y + 1) * stride + x - 1] |= SIG_NE
    flags[(y - 1) * stride + x + 1] |= SIG_SW
    flags[(y - 1) * stride + x - 1] |= SIG_SE


def _sigpass(mqc, data, flags, stride, width, height, bpno, bandno, vsc):
    mask = 3 << (bpno - 1)
    for y0 in range(0, height, 4):
        for x in range(width):
            for y in range(y0, min(height, y0 + 4)):
                fmask = 0xFFFFFFFF
                if vsc and y == y0 + 3:
                    fmask &= ~(SIG_S | SIG_SW | SIG_SE | SGN_S) & 0xFFFFFFFF
                f = flags[(y + 1) * stride + x + 1]
                if (f & SIG_NB & fmask) and not (f & (SIG | VIS)):
                    if mqc.decode(int(SIGCTX_LUT[f & fmask & 255, bandno])):
                        fm = f & fmask
                        xorbit = int(XORBIT_LUT[fm & 15, (fm >> 8) & 15])
                        ctxno = int(SGNCTX_LUT[fm & 15, (fm >> 8) & 15])
                        if mqc.raw:
                            data[y * stride + x] |= mqc.decode(ctxno) << 31
                        else:
                            data[y * stride + x] |= (mqc.decode(ctxno) ^ xorbit) << 31
                        data[y * stride + x] |= mask
                        _set_significance(flags, stride, x, y,
                                          bool(data[y * stride + x] & 0x80000000))
                    flags[(y + 1) * stride + x + 1] |= VIS


def _refpass(mqc, data, flags, stride, width, height, bpno, vsc):
    phalf = 1 << (bpno - 1)
    for y0 in range(0, height, 4):
        for x in range(width):
            for y in range(y0, min(height, y0 + 4)):
                f = flags[(y + 1) * stride + x + 1]
                if (f & (SIG | VIS)) == SIG:
                    fmask = 0xFFFFFFFF
                    if vsc and y == y0 + 3:
                        fmask &= ~(SIG_S | SIG_SW | SIG_SE | SGN_S) & 0xFFFFFFFF
                    fm = f & fmask
                    ctxno = int(REFCTX_LUT[(fm >> 14) & 1, int((fm & 255) != 0)])
                    data[y * stride + x] |= phalf
                    if mqc.decode(ctxno):
                        data[y * stride + x] |= phalf << 1
                    else:
                        data[y * stride + x] &= ~(phalf << 1) & 0xFFFFFFFF
                    flags[(y + 1) * stride + x + 1] |= REF


def _clnpass(mqc, data, flags, stride, width, height, bpno, bandno,
             seg_symbols, vsc):
    mask = 3 << (bpno - 1)
    for y0 in range(0, height, 4):
        for x in range(width):
            fmask = 0xFFFFFFFF
            if vsc:
                fmask &= ~(SIG_S | SIG_SW | SIG_SE | SGN_S) & 0xFFFFFFFF
            if (y0 + 3 < height
                    and not (
                        (flags[(y0 + 1) * stride + x + 1] & (SIG_NB | VIS | SIG))
                        or (flags[(y0 + 2) * stride + x + 1] & (SIG_NB | VIS | SIG))
                        or (flags[(y0 + 3) * stride + x + 1] & (SIG_NB | VIS | SIG))
                        or (flags[(y0 + 4) * stride + x + 1]
                            & (SIG_NB | VIS | SIG) & fmask))):
                if not mqc.decode(tb.MQC_CX_RL):
                    continue
                runlen = mqc.decode(tb.MQC_CX_UNI)
                runlen = (runlen << 1) | mqc.decode(tb.MQC_CX_UNI)
                dec = 1
            else:
                runlen = 0
                dec = 0

            for y in range(y0 + runlen, min(y0 + 4, height)):
                fmask = 0xFFFFFFFF
                if vsc and y == y0 + 3:
                    fmask &= ~(SIG_S | SIG_SW | SIG_SE | SGN_S) & 0xFFFFFFFF
                f = flags[(y + 1) * stride + x + 1]
                if not dec:
                    if not (f & (SIG | VIS)):
                        dec = mqc.decode(int(SIGCTX_LUT[f & fmask & 255, bandno]))
                if dec:
                    fm = f & fmask
                    xorbit = int(XORBIT_LUT[fm & 15, (fm >> 8) & 15])
                    ctxno = int(SGNCTX_LUT[fm & 15, (fm >> 8) & 15])
                    data[y * stride + x] |= (mqc.decode(ctxno) ^ xorbit) << 31
                    data[y * stride + x] |= mask
                    _set_significance(flags, stride, x, y,
                                      bool(data[y * stride + x] & 0x80000000))
                dec = 0
                flags[(y + 1) * stride + x + 1] &= ~VIS & 0xFFFFFFFF

    if seg_symbols:
        val = mqc.decode(tb.MQC_CX_UNI)
        val = (val << 1) + mqc.decode(tb.MQC_CX_UNI)
        val = (val << 1) + mqc.decode(tb.MQC_CX_UNI)
        val = (val << 1) + mqc.decode(tb.MQC_CX_UNI)
        if val != 0xA:
            from ffmpeg_ht_tpu_torch.utils.log import logger
            logger.error("Segmentation symbol value incorrect")


def needs_termination(style: int, passno: int) -> int:
    from ffmpeg_ht_tpu_torch.codestream.t2 import needs_termination as nt
    return nt(style, passno)


def decode_cblk(data: bytes, npasses: int, nonzerobits: int, cblk_style: int,
                width: int, height: int, bandpos: int, magb: int,
                roi_shift: int = 0, nb_terminations: int = 0,
                data_start=None, log2_cblk_width: int = 6) -> np.ndarray:
    """Legacy MQ/EBCOT code-block decode (jpeg2000dec.c:1993-2089).

    Returns (height, width) int32 sign-magnitude samples with binary point
    at 31 - magb (same convention as decode_htj2k). The native tier
    (native/ebcot.c) carries the per-sample serial work; this Python body
    doubles as the behavioral oracle and the no-compiler fallback.
    """
    from ffmpeg_ht_tpu_torch.utils import native
    res = native.ebcot_decode_cblk(
        bytes(data), npasses, nonzerobits, cblk_style, width, height,
        bandpos, magb, roi_shift, nb_terminations, data_start,
        log2_cblk_width)
    if res is not None:
        return res

    stride = (1 << log2_cblk_width) + 2
    d = np.zeros(stride * height, dtype=np.uint32)
    out = np.zeros((height, width), dtype=np.int32)
    if len(data) == 0 or npasses == 0:
        return out
    flags = np.zeros(stride * (height + 2), dtype=np.uint32)

    buf = bytearray(data) + b"\xff\xff"
    mqc = MQDecoder(buf, 0, raw=False, reset=True)
    vsc = cblk_style & 0x08  # JPEG2000_CBLK_VSC

    bpno = nonzerobits - 1 + 31 - magb - 1 - roi_shift
    pass_t = 2
    pass_cnt = 0
    term_cnt = 0
    passno = npasses
    if data_start is None:
        data_start = [0]

    while passno > 0:
        passno -= 1
        if bpno < 0 or bpno > 29:
            raise InvalidData("bpno became invalid")
        if pass_t == 0:
            _sigpass(mqc, d, flags, stride, width, height, bpno + 1,
                     bandpos, vsc)
        elif pass_t == 1:
            _refpass(mqc, d, flags, stride, width, height, bpno + 1, vsc)
        else:
            _clnpass(mqc, d, flags, stride, width, height, bpno + 1, bandpos,
                     cblk_style & 0x20, vsc)
        if cblk_style & 0x02:  # RESET
            mqc.cx_states = tb.mq_initial_cx_states()

        if passno:
            coder_type = needs_termination(cblk_style, pass_cnt)
            if coder_type:
                if term_cnt >= nb_terminations:
                    raise InvalidData("Missing needed termination")
                term_cnt += 1
                mqc.reinit(data_start[term_cnt], raw=(coder_type == 2),
                           reset=False)

        pass_t += 1
        if pass_t == 3:
            bpno -= 1
            pass_t = 0
        pass_cnt += 1

    # ROI shift + writeback (jpeg2000dec.c:2072-2087)
    mask = (1 << 32) - 1 >> (magb + 1)
    vals = d.reshape(height, stride)[:, :width].astype(np.int64)
    sign = vals & 0x80000000
    mag = vals & 0x7FFFFFFF
    if roi_shift:
        roi = (mag & ~mask & 0x7FFFFFFF) == 0
        mag = np.where(roi, (mag << roi_shift) & 0x7FFFFFFF, mag)
    return (mag | sign).astype(np.uint32).view(np.int32).reshape(height, width).copy()
