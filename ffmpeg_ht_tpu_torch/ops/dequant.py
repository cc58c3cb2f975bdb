"""Dequantization of sign-magnitude T1 output into band coefficients.

Behavior parity: dequantization_float / _int / _int_97
(jpeg2000dec.c:2098-2181). Input is int32 sign-magnitude (bit 31 = sign,
binary point at 31 - M_b); output is the tile-component plane dtype
(int32 for 5/3 and 9/7-int, float32 for 9/7 float).
"""

from __future__ import annotations

import numpy as np

I_PRESHIFT = 8


def dequant_float(src: np.ndarray, f_stepsize: float, magb: int) -> np.ndarray:
    """jpeg2000dec.c:2098-2117."""
    downshift = 31 - magb
    fscale = np.float32(f_stepsize) / np.float32(1 << downshift)
    val = src.astype(np.int64)
    neg = val < 0
    mag = np.where(neg, -(val & 0x7FFFFFFF), val)
    return (mag.astype(np.float32) * fscale).astype(np.float32)


def dequant_int(src: np.ndarray, i_stepsize: int, magb: int) -> np.ndarray:
    """jpeg2000dec.c:2119-2151 (reversible path)."""
    downshift = 31 - magb
    val = src.astype(np.int64)
    neg = val < 0
    shifted = (val & 0x7FFFFFFF) >> downshift
    out = np.where(neg, -shifted, shifted)
    if i_stepsize != 32768:
        out = (out * i_stepsize) // 65536
    return out.astype(np.int32)


PRESCALE = 6


def int97_scale(f_stepsize: float, magb: int) -> int:
    """The integer Q16 scale of the bitexact 9/7 path, reproducing the
    reference's float32 chain (jpeg2000dec.c:2158-2166). Shared by the
    host oracle and the device assembly so both dequantize identically."""
    downshift = 31 - magb
    f = np.float32(f_stepsize)
    f = f / np.float32(1 << downshift)
    f = f * np.float32(1 << PRESCALE)
    f = f * np.float32(1 << (16 + I_PRESHIFT))
    return int(np.float32(f) + np.float32(0.5))


def dequant_int_97(src: np.ndarray, f_stepsize: float, magb: int) -> np.ndarray:
    """jpeg2000dec.c:2153-2181 (bitexact 9/7 integer path, PRESCALE=6)."""
    scale = int97_scale(f_stepsize, magb)

    val = src.astype(np.int64)
    neg = val < 0
    mag = np.where(neg, -(val & 0x7FFFFFFF), val)
    mag = (mag + (1 << (PRESCALE - 1))) >> PRESCALE
    prod = mag * scale
    # RSHIFT: rounded shift toward -inf for negatives (a + (1<<15)) >> 16 /
    # C macro RSHIFT(a,b) = (a > 0 ? (a + (1<<(b-1))) >> b : (a + (1<<(b-1)) - 1) >> b)
    out = np.where(prod > 0, (prod + (1 << 15)) >> 16,
                   (prod + (1 << 15) - 1) >> 16)
    return out.astype(np.int32)
