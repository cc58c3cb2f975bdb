"""EBCOT Tier-1 encoder (ISO 15444-1, MQ-coded sig/ref/cln passes).

Behavior parity: encode_sigpass/encode_refpass/encode_clnpass/encode_cblk
(/root/reference/libavcodec/j2kenc.c:616-767) including the NMSEDEC
distortion bookkeeping used by rate control. Context LUTs are shared with
the decoder (ops/ebcot.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from ffmpeg_ht_tpu_torch.ops import tables as tb
from ffmpeg_ht_tpu_torch.ops.ebcot import (REFCTX_LUT, SGNCTX_LUT, SIG, SIG_NB,
                                     SIGCTX_LUT, VIS, XORBIT_LUT,
                                     _set_significance)
from ffmpeg_ht_tpu_torch.ops.mq_enc import MQEncoder

SGN = 0x8000  # JPEG2000_T1_SGN (jpeg2000.h:106)
REF = 0x4000

NMSEDEC_BITS = 7
NMSEDEC_FRACBITS = NMSEDEC_BITS - 1


def _build_nmsedec_luts():
    """init_luts (j2kenc.c:584-599)."""
    n = 1 << NMSEDEC_BITS
    mask = ~((1 << NMSEDEC_FRACBITS) - 1)
    sig = np.zeros(n, dtype=np.int64)
    sig0 = np.zeros(n, dtype=np.int64)
    ref = np.zeros(n, dtype=np.int64)
    ref0 = np.zeros(n, dtype=np.int64)
    for i in range(n):
        sig[i] = max((3 * i << (13 - NMSEDEC_FRACBITS)) - (9 << 11), 0)
        sig0[i] = max(((i * i + (1 << (NMSEDEC_FRACBITS - 1))) & mask) << 1, 0)
        a = ((i >> (NMSEDEC_BITS - 2)) & 2) + 1
        ref[i] = max((a - 2) * (i << (13 - NMSEDEC_FRACBITS))
                     + (1 << 13) - (a * a << 11), 0)
        ref0[i] = max((((i * i - (i << NMSEDEC_BITS)
                         + (1 << 2 * NMSEDEC_FRACBITS)
                         + (1 << (NMSEDEC_FRACBITS - 1))) & mask) << 1), 0)
    return sig, sig0, ref, ref0


_LUT_SIG, _LUT_SIG0, _LUT_REF, _LUT_REF0 = _build_nmsedec_luts()
_NMASK = (1 << NMSEDEC_BITS) - 1


def _nmsedec_sig(x: int, bpno: int) -> int:
    if bpno > NMSEDEC_FRACBITS:
        return int(_LUT_SIG[(x >> (bpno - NMSEDEC_FRACBITS)) & _NMASK])
    return int(_LUT_SIG0[x & _NMASK])


def _nmsedec_ref(x: int, bpno: int) -> int:
    if bpno > NMSEDEC_FRACBITS:
        return int(_LUT_REF[(x >> (bpno - NMSEDEC_FRACBITS)) & _NMASK])
    return int(_LUT_REF0[x & _NMASK])


@dataclass
class Pass:
    rate: int = 0
    disto: int = 0
    flushed: bytes = b""


@dataclass
class EncCblk:
    """Per-codeblock encode result consumed by rate control and T2."""
    nonzerobits: int = 0
    npasses: int = 0
    ninclpasses: int = 0
    data: bytes = b""
    passes: List[Pass] = field(default_factory=list)
    # T2 state
    incl: bool = False
    lblock: int = 3
    layers: List[dict] = field(default_factory=list)


def _sigpass_enc(mqc, data, flags, stride, width, height, bandno, bpno):
    mask = 1 << (bpno + NMSEDEC_FRACBITS)
    nmsedec = 0
    for y0 in range(0, height, 4):
        for x in range(width):
            for y in range(y0, min(height, y0 + 4)):
                f = flags[(y + 1) * stride + x + 1]
                if not (f & SIG) and (f & SIG_NB):
                    ctxno = int(SIGCTX_LUT[f & 255, bandno])
                    bit = 1 if data[y * stride + x] & mask else 0
                    mqc.encode(ctxno, bit)
                    if bit:
                        xorbit = int(XORBIT_LUT[f & 15, (f >> 8) & 15])
                        sctx = int(SGNCTX_LUT[f & 15, (f >> 8) & 15])
                        mqc.encode(sctx, ((f >> 15) & 1) ^ xorbit)
                        nmsedec += _nmsedec_sig(int(data[y * stride + x]),
                                                bpno + NMSEDEC_FRACBITS)
                        _set_significance(flags, stride, x, y,
                                          bool(f & SGN))
                    flags[(y + 1) * stride + x + 1] |= VIS
    return nmsedec


def _refpass_enc(mqc, data, flags, stride, width, height, bpno):
    mask = 1 << (bpno + NMSEDEC_FRACBITS)
    nmsedec = 0
    for y0 in range(0, height, 4):
        for x in range(width):
            for y in range(y0, min(height, y0 + 4)):
                f = flags[(y + 1) * stride + x + 1]
                if (f & (SIG | VIS)) == SIG:
                    ctxno = int(REFCTX_LUT[(f >> 14) & 1, int((f & 255) != 0)])
                    nmsedec += _nmsedec_ref(int(data[y * stride + x]),
                                            bpno + NMSEDEC_FRACBITS)
                    mqc.encode(ctxno, 1 if data[y * stride + x] & mask else 0)
                    flags[(y + 1) * stride + x + 1] |= REF
    return nmsedec


def _clnpass_enc(mqc, data, flags, stride, width, height, bandno, bpno):
    mask = 1 << (bpno + NMSEDEC_FRACBITS)
    nmsedec = 0
    for y0 in range(0, height, 4):
        for x in range(width):
            if (y0 + 3 < height
                    and not (
                        (flags[(y0 + 1) * stride + x + 1] & (SIG_NB | VIS | SIG))
                        or (flags[(y0 + 2) * stride + x + 1] & (SIG_NB | VIS | SIG))
                        or (flags[(y0 + 3) * stride + x + 1] & (SIG_NB | VIS | SIG))
                        or (flags[(y0 + 4) * stride + x + 1] & (SIG_NB | VIS | SIG)))):
                # aggregation mode
                rlen = 0
                while rlen < 4 and not (data[(y0 + rlen) * stride + x] & mask):
                    rlen += 1
                mqc.encode(tb.MQC_CX_RL, int(rlen != 4))
                if rlen == 4:
                    continue
                mqc.encode(tb.MQC_CX_UNI, rlen >> 1)
                mqc.encode(tb.MQC_CX_UNI, rlen & 1)
                for y in range(y0 + rlen, y0 + 4):
                    f = flags[(y + 1) * stride + x + 1]
                    if not (f & (SIG | VIS)):
                        ctxno = int(SIGCTX_LUT[f & 255, bandno])
                        if y > y0 + rlen:
                            mqc.encode(ctxno,
                                       1 if data[y * stride + x] & mask else 0)
                        if data[y * stride + x] & mask:  # newly significant
                            xorbit = int(XORBIT_LUT[f & 15, (f >> 8) & 15])
                            sctx = int(SGNCTX_LUT[f & 15, (f >> 8) & 15])
                            nmsedec += _nmsedec_sig(int(data[y * stride + x]),
                                                    bpno + NMSEDEC_FRACBITS)
                            mqc.encode(sctx, ((f >> 15) & 1) ^ xorbit)
                            _set_significance(flags, stride, x, y, bool(f & SGN))
                    flags[(y + 1) * stride + x + 1] &= ~np.uint32(VIS)
            else:
                for y in range(y0, min(y0 + 4, height)):
                    f = flags[(y + 1) * stride + x + 1]
                    if not (f & (SIG | VIS)):
                        ctxno = int(SIGCTX_LUT[f & 255, bandno])
                        mqc.encode(ctxno, 1 if data[y * stride + x] & mask else 0)
                        if data[y * stride + x] & mask:  # newly significant
                            xorbit = int(XORBIT_LUT[f & 15, (f >> 8) & 15])
                            sctx = int(SGNCTX_LUT[f & 15, (f >> 8) & 15])
                            nmsedec += _nmsedec_sig(int(data[y * stride + x]),
                                                    bpno + NMSEDEC_FRACBITS)
                            mqc.encode(sctx, ((f >> 15) & 1) ^ xorbit)
                            _set_significance(flags, stride, x, y, bool(f & SGN))
                    flags[(y + 1) * stride + x + 1] &= ~np.uint32(VIS)
    return nmsedec


def encode_cblk(t1data: np.ndarray, width: int, height: int,
                bandpos: int) -> EncCblk:
    """Encode one code-block (encode_cblk, j2kenc.c:707-767).

    `t1data` is an (height, width) int64/int32 array of coefficients already
    scaled by 2**NMSEDEC_FRACBITS (signed two's complement).
    """
    stride = width + 2
    data = np.zeros(stride * height, dtype=np.int64)
    flags = np.zeros(stride * (height + 2), dtype=np.uint32)

    maxval = 0
    for y in range(height):
        for x in range(width):
            v = int(t1data[y, x])
            if v < 0:
                flags[(y + 1) * stride + x + 1] |= SGN
                v = -v
            data[y * stride + x] = v
            if v > maxval:
                maxval = v

    cblk = EncCblk()
    if maxval == 0:
        cblk.nonzerobits = 0
    else:
        cblk.nonzerobits = maxval.bit_length() - NMSEDEC_FRACBITS
    bpno = cblk.nonzerobits - 1

    mqc = MQEncoder()
    pass_t = 2
    wmsedec = 0
    while bpno >= 0:
        if pass_t == 0:
            nmsedec = _sigpass_enc(mqc, data, flags, stride, width, height,
                                   bandpos, bpno)
        elif pass_t == 1:
            nmsedec = _refpass_enc(mqc, data, flags, stride, width, height,
                                   bpno)
        else:
            nmsedec = _clnpass_enc(mqc, data, flags, stride, width, height,
                                   bandpos, bpno)
        rate, flushed = mqc.flush_to()
        wmsedec += nmsedec << (2 * bpno)
        cblk.passes.append(Pass(rate=rate, disto=wmsedec, flushed=flushed))
        pass_t += 1
        if pass_t == 3:
            pass_t = 0
            bpno -= 1

    cblk.npasses = len(cblk.passes)
    cblk.ninclpasses = len(cblk.passes)
    cblk.data = mqc.committed_bytes() + b"\x00" * 8  # slack like data[8192+1]
    return cblk
