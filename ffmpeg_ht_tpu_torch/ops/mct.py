"""Inverse multiple-component transforms: RCT (reversible) and ICT.

Behavior parity: jpeg2000dsp.c:43-91. These operate on whole tile-component
planes; on TPU they fuse with dequant + DC shift into one elementwise kernel.
"""

from __future__ import annotations

import numpy as np

F_ICT = (np.float32(1.402), np.float32(0.34413),
         np.float32(0.71414), np.float32(1.772))

I_ICT = (91881, 22553, 46802, 116130)


def ict_float(y0: np.ndarray, y1: np.ndarray, y2: np.ndarray):
    """Irreversible inverse ICT, float32 (jpeg2000dsp.c:43-59)."""
    i0 = y0 + F_ICT[0] * y2
    i1 = y0 - F_ICT[1] * y1 - F_ICT[2] * y2
    i2 = y0 + F_ICT[3] * y1
    return i0, i1, i2


def ict_int(y0: np.ndarray, y1: np.ndarray, y2: np.ndarray):
    """Irreversible inverse ICT in fixed point (jpeg2000dsp.c:61-76).

    Matches the reference's u32-wraparound arithmetic:
      i0 = y0 + y2 + ((26345 * y2 + 2^15) >> 16)
      i1 = y0 - ((22553 * y1 + 2^15) >> 16) - ((46802 * y2 + 2^15) >> 16)
      i2 = y0 + 2*y1 + ((-14942 * y1 + 2^15) >> 16)
    with products computed mod 2^32 and shifted arithmetically.
    """
    def qmul(c: int, v: np.ndarray) -> np.ndarray:
        prod = (np.int64(c & 0xFFFFFFFF) * v.astype(np.int64)) & 0xFFFFFFFF
        prod = (prod + (1 << 15)) & 0xFFFFFFFF
        return (prod.astype(np.uint32).view(np.int32).astype(np.int64) >> 16) \
            .astype(np.int32)

    y0 = y0.astype(np.int32)
    y1 = y1.astype(np.int32)
    y2 = y2.astype(np.int32)
    i0 = y0 + y2 + qmul(26345, y2)
    i1 = y0 - qmul(I_ICT[1], y1) - qmul(I_ICT[2], y2)
    i2 = y0 + 2 * y1 + qmul(-14942 & 0xFFFFFFFF, y1)
    return i0, i1, i2


def rct_int(y0: np.ndarray, y1: np.ndarray, y2: np.ndarray):
    """Reversible inverse RCT in wraparound arithmetic (jpeg2000dsp.c:78-91)."""
    u0 = y0.view(np.uint32) if y0.dtype == np.int32 else y0.astype(np.uint32)
    u1 = y1.view(np.uint32) if y1.dtype == np.int32 else y1.astype(np.uint32)
    u2 = y2.view(np.uint32) if y2.dtype == np.int32 else y2.astype(np.uint32)
    g = u0 - ((u2 + u1).view(np.int32) >> 2).view(np.uint32)
    r = g + u2
    b = g + u1
    return (r.view(np.int32), g.view(np.int32), b.view(np.int32))


def rct_fwd(r: np.ndarray, g: np.ndarray, b: np.ndarray):
    """Forward reversible component transform (T.800 G.2; exact inverse of
    rct_int)."""
    y0 = (r + 2 * g + b) >> 2
    return y0, b - g, r - g


def ict_fwd(r: np.ndarray, g: np.ndarray, b: np.ndarray):
    """Forward irreversible component transform (T.800 G.3, float).

    Lossy pair of ict_float/ict_int; the roundtrip is approximate by
    design (the decoder-vs-decoder parity tests judge bit-exactness, not
    the roundtrip)."""
    r = r.astype(np.float64)
    g = g.astype(np.float64)
    b = b.astype(np.float64)
    y0 = 0.299 * r + 0.587 * g + 0.114 * b
    y1 = -0.16875 * r - 0.33126 * g + 0.5 * b
    y2 = 0.5 * r - 0.41869 * g - 0.08131 * b
    return y0, y1, y2


def mct_decode(transform: int, c0, c1, c2):
    """Dispatch by DWT type (jpeg2000dsp.c:93-98 / jpeg2000dec.c:2183-2209)."""
    from ffmpeg_ht_tpu_torch.ops.dwt import DWT97, DWT97_INT
    if transform == DWT97:
        return ict_float(c0, c1, c2)
    if transform == DWT97_INT:
        return ict_int(c0, c1, c2)
    return rct_int(c0, c1, c2)
