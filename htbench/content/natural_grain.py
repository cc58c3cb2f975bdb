"""Natural texture with film grain: ``natural`` plus Gaussian noise of
standard deviation `sigma` codes, drawn for every sample of every
component, rounded and clipped to the depth's range.

Grain of about 1% of full scale is what a scan of 35 mm film carries; it
roughly doubles the entropy-coded bytes of a lossless frame.
"""

from __future__ import annotations

import numpy as np

from . import natural


def make(rng, height: int, width: int, components: int, depth: int,
         sigma: float):
    img = natural.make(rng, height, width, components, depth)
    grain = np.rint(rng.normal(0.0, sigma, img.shape))
    out = np.clip(img.astype(np.int32) + grain.astype(np.int32), 0,
                  (1 << depth) - 1)
    return out.astype(img.dtype)
