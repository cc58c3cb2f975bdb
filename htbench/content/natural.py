"""Natural texture: mixed-frequency value noise, the stand-in for
cinema and photographic content.

Octaves at 8, 32, 128 and 512 pixels give fine texture and large
structure. Copied from ``ffmpeg_ht_tpu_torch/bench.py`` (``_natural``,
``_mk444``), with the generator passed in: three components are the
plane and two shifted copies of it, as the port's bench makes them.
"""

from __future__ import annotations

import numpy as np


def natural_plane(rng, h, w, lo, hi, dtype):
    acc = np.zeros((h, w))
    for period, amp in ((8, 0.5), (32, 0.25), (128, 0.15), (512, 0.1)):
        g = rng.standard_normal((h // period + 2, w // period + 2))
        yi = np.arange(h) / period
        xi = np.arange(w) / period
        y0 = yi.astype(int)
        x0 = xi.astype(int)
        fy = (yi - y0)[:, None]
        fx = (xi - x0)[None, :]
        a, b = g[y0][:, x0], g[y0][:, x0 + 1]
        c, d = g[y0 + 1][:, x0], g[y0 + 1][:, x0 + 1]
        acc += amp * ((a * (1 - fx) + b * fx) * (1 - fy)
                      + (c * (1 - fx) + d * fx) * fy)
    acc = (acc - acc.min()) / (np.ptp(acc) + 1e-9)
    return (acc * (hi - lo) + lo).astype(dtype)


def mk444(plane):
    return np.stack([plane, np.roll(plane, 5, 1), np.roll(plane, 9, 0)],
                    axis=2)


def sample_dtype(depth: int):
    return np.uint8 if depth <= 8 else np.uint16


def make(rng, height: int, width: int, components: int, depth: int):
    """One frame: (height, width) for one component, (height, width, 3)
    for three, samples in [0, 2**depth)."""
    plane = natural_plane(rng, height, width, 0, (1 << depth) - 1,
                          sample_dtype(depth))
    if components == 1:
        return plane
    if components == 3:
        return mk444(plane)
    raise ValueError(f"natural content has 1 or 3 components, not "
                     f"{components}")
