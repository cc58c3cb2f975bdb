"""Forward multiple-component transforms of the encoder: RCT
(reversible) and ICT, on whole tile-component planes."""

from __future__ import annotations

import numpy as np

def rct_fwd(r: np.ndarray, g: np.ndarray, b: np.ndarray):
    """Forward reversible component transform (T.800 G.2)."""
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


