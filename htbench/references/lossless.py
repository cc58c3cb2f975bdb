"""The plain reference of a lossless configuration: its source pixels.

A lossless decode returns the source exactly, so the source, put into
the decoder's output format, is what every frame is held to: samples of
more than 8 bits stand MSB-aligned in 16 bits (``check_lossless`` of
``ffmpeg_ht_tpu_torch/bench.py``), gray is one plane, three components
one packed plane. A frame is right when every sample equals its
reference; that covers parse, entropy decode, dequant, inverse DWT,
inverse RCT, DC shift, clip, pack and frame write together.
"""

from __future__ import annotations

import numpy as np


def expected(source: np.ndarray, depth: int) -> np.ndarray:
    """The frame a lossless decode of `source` returns, as (H, W) or
    (H, W, C) samples."""
    if depth > 8:
        return source.astype(np.uint16) << (16 - depth)
    return source


def lower_precision(source: np.ndarray, depth: int) -> np.ndarray:
    """The control: the source kept at depth - 1 bits (its least
    significant bit cleared), the precision one step below the lossless
    one that the configuration states."""
    return source & ~np.array(1, source.dtype)


def judge(planes, width: int, height: int, want: np.ndarray):
    """(samples that differ, widest absolute difference) of a decoded
    frame's planes against `want`; a frame of the wrong shape differs in
    every sample."""
    if (len(planes) != 1 or planes[0].size != want.size
            or (width, height) != (want.shape[1], want.shape[0])):
        return int(want.size), None
    got = planes[0].reshape(want.shape)
    diff = got != want
    n = int(np.count_nonzero(diff))
    if n == 0:
        return 0, 0
    wide = np.abs(got[diff].astype(np.int64) - want[diff].astype(np.int64))
    return n, int(wide.max())
