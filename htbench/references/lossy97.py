"""The plain reference of a lossy float 9/7 + ICT configuration.

A lossy decode does not return its source, so the source is first taken
through the frozen encoder's own forward path (``htbench/frozen``), as
``encode_frame_htj2k`` does with ``pred=0, mct=True``: DC level shift,
forward ICT rounded to integers, the encoder's integer 9/7 analysis and
its deadzone scalar quantization, band by band with the j2kenc step
sizes. That gives the quantization indices the stream carries. The
decode is then written out here in plain torch, float64:

- dequantization at the decoder's reconstruction point: a nonzero index
  q stands for sign(q) (|q| + 1/2) delta_b (T.800 E.1.1.2 with r = 1/2,
  the half bit ffmpeg's HT decoder sets), 0 for 0;
- the inverse 9/7 lifting of T.800 Annex F (F.3.8.2, the 1D_SR
  procedure), level by level, rows then columns;
- the inverse ICT of T.800 Annex G (G.3);
- the DC level shift, rounding half to even, clipping to the depth, and
  the packed (H, W, 3) plane the decoder returns.

It imports neither JAX nor the program: only the frozen encoder, numpy
and torch.

Departures from the published description, each as ffmpeg
(``libavcodec/jpeg2000.c``, ``jpeg2000dwt.c``, ``jpeg2000dec.c``) and
the JAX package (``models/assembly.py`` dequant and ``ict_float``,
``ops/dwt_jax.py``) decode, for this is what the configuration is held
to:

- the step size delta_b (``band_step``) is computed here from the
  exponent and mantissa the stream signals (E.1.1.1): 2^(R_b - e_b)
  (1 + mu_b / 2^11) with R_b = the depth for every band, the band's
  gain of 2 a high-pass direction (R_I + log2 gain_b) moved into the
  9/7 fold below. The lifting scales no line by K or 1/K (steps 1 and 2
  of F.3.8.2), except a line of one sample (x K / 2 on an odd one, x X
  on an even one), so delta_b carries those scales: x 2X once for a
  band with one high-pass direction (HL, LH), x 4X^2 once for HH (X =
  1/K), and x K^(2 n - h), n the synthesis levels the band passes
  through and h its high-pass directions. float32 after each product,
  as ffmpeg's ``init_band_stepsize`` stores into a float, with its
  float constants. The frozen geometry gives band coordinates and the
  encoder's integer step only, not this one;
- the lifting constants and the ICT's (1.402, 0.34413, 0.71414, 1.772)
  are ffmpeg's decimals;
- the coefficient of a sample is rounded once, after the ICT (``rint``,
  half to even), then shifted by 2^(depth - 1) and clipped.

Everything runs in float64 (``DTYPE``), with TF32 off for any device
matmul. The configuration states the float 9/7, which ffmpeg decodes
within 1 LSB of any exact inverse: float32 rounding on either side lands
on the other integer near a half. So a sample is wrong when it differs
by more than ``TOLERANCE`` = 1 from this one. That bar alone does not
tell float32 from float16: this inverse in float16 stays within 1 LSB
of float64 at every size tried, and moves 5-7% of the samples by 1,
where float32 moves about 1 in 100,000. So a frame is also wrong when
more than ``ONE_LSB_SHARE`` of its samples are 1 LSB off. The geometry
is one tile holding the frame at the origin, ``NRESLEVELS`` resolution
levels.
"""

from __future__ import annotations

import numpy as np
import torch

from htbench.frozen.codestream import markers as mk
from htbench.frozen.codestream.geometry import init_tile
from htbench.frozen.codestream.structures import (CodingStyle, ComponentInfo,
                                                 MainHeader, QuantStyle, SIZ,
                                                 TileHeader)
from htbench.frozen.models.encoder import _init_quantization
from htbench.frozen.ops import dwt as dwtmod
from htbench.frozen.ops import mct as mctmod

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NRESLEVELS = 6          # 5 DWT levels, as hd1080-rgb8-ict97's encoder
TOLERANCE = 1           # LSB
ONE_LSB_SHARE = 1e-3    # of a frame's samples, at most 1 LSB off
DTYPE = torch.float64

# T.800 Table F.4, as ffmpeg's F_LFTG_* (the signs in the steps below)
ALPHA, BETA = 1.586134342059924, 0.052980118572961
GAMMA, DELTA = 0.882911075530934, 0.443506852043971
K = 1.230174104914001
X = 0.812893066115961                 # 1 / K
_K32, _X32 = np.float32(K), np.float32(X)   # ffmpeg's F_LFTG_K, F_LFTG_X
_PAD = 8


def _tile(height: int, width: int, depth: int):
    """The encoder's tile (its band coordinates and integer 9/7 steps)
    and the quantization it signals. The codeblock size does not change
    a quantization index."""
    codsty = CodingStyle(nreslevels=NRESLEVELS, nreslevels2decode=NRESLEVELS,
                         log2_cblk_width=6, log2_cblk_height=6,
                         cblk_style=mk.CTSY_HTJ2K_F, mct=1,
                         transform=mk.DWT97_INT, init=True)
    qntsty = QuantStyle(nguardbits=2, quantsty=mk.QSTY_SE)
    _init_quantization(codsty, qntsty, depth)
    siz = SIZ(rsiz=0x4000, width=width, height=height, tile_width=width,
              tile_height=height,
              components=[ComponentInfo(depth=depth, sgnd=False, dx=1,
                                        dy=1)] * 3)
    hdr = MainHeader(siz=siz)
    hdr.tiles.append(TileHeader(codsty=[codsty.copy() for _ in range(3)],
                                qntsty=[qntsty.copy() for _ in range(3)],
                                roi_shift=[0] * 3))
    return init_tile(hdr, 0), qntsty


def band_step(expn: int, mant: int, depth: int, reslevel: int,
              band: int) -> float:
    """delta_b of a band as the float 9/7 decode uses it (module
    docstring), from its signalled exponent `expn` and mantissa `mant`:
    `reslevel` 0 is the LL band, above it `band` 0, 1, 2 is HL, LH,
    HH."""
    f = np.float32(2.0 ** (depth - expn))                    # exact
    f = np.float32(float(f) * (mant / 2048.0 + 1.0))
    high = 0 if reslevel == 0 else (2 if band == 2 else 1)
    if high == 1:
        f = np.float32(float(f) * float(_X32 * 2))
    elif high == 2:
        f = np.float32(float(f) * float(np.float32(_X32 * _X32) * 4))
    through = NRESLEVELS - max(reslevel, 1)
    f = np.float32(float(f) * float(_K32) ** (2 * through - high))
    return float(f)


def quantized(source: np.ndarray, depth: int):
    """The frozen encoder's forward path of an (H, W, 3) source: the
    quantization indices of each component (3, H, W, int64, in the
    deinterleaved band layout of its DWT), and the float decoder's step
    size at each of them (3, H, W, float64)."""
    h, w = source.shape[:2]
    enc, qntsty = _tile(h, w, depth)
    raw = [source[:, :, c].astype(np.int32) - (1 << (depth - 1))
           for c in range(3)]
    raw = [np.rint(y).astype(np.int32) for y in mctmod.ict_fwd(*raw)]
    q = np.zeros((3, h, w), np.int64)
    step = np.zeros((3, h, w), np.float64)
    for c, ce in enumerate(enc.comp):
        plane = dwtmod.dwt_encode(raw[c], ce.coord, NRESLEVELS - 1,
                                  mk.DWT97_INT)
        gbandno = 0
        for r, rle in enumerate(ce.reslevel):
            for b, be in enumerate(rle.band):
                delta = band_step(qntsty.expn[gbandno], qntsty.mant[gbandno],
                                  depth, r, b)
                gbandno += 1
                scale = (16384 * 65536) // be.i_stepsize
                for pr in be.prec:
                    for cb in pr.cblk:
                        if cb.width <= 0 or cb.height <= 0:
                            continue
                        x0 = cb.coord[0][0] - be.coord[0][0]
                        y0 = cb.coord[1][0] - be.coord[1][0]
                        sl = (slice(y0, y0 + cb.height),
                              slice(x0, x0 + cb.width))
                        blk = plane[sl].astype(np.int64)
                        m = (np.abs(blk) * scale) >> 15
                        q[c][sl] = np.where(blk < 0, -m, m)
                        step[c][sl] = delta
    return q, step


def _extend(p, i0: int, i1: int) -> None:
    """Whole-sample symmetric extension by 4 (F.3.7)."""
    for i in range(1, 5):
        p[..., _PAD + i0 - i] = p[..., _PAD + i0 + i]
        p[..., _PAD + i1 + i - 1] = p[..., _PAD + i1 - i - 1]


def _lift(p, lo: int, hi: int, coef: float, parity: int, sign: int) -> None:
    """p[2i + parity] += sign * coef * (its two neighbours) for i in
    [lo, hi)."""
    a, b = _PAD + 2 * lo + parity, _PAD + 2 * hi + parity
    p[..., a:b:2] += sign * coef * (p[..., a - 1:b - 1:2]
                                    + p[..., a + 1:b + 1:2])


def _sr_1d(rows, mh: int):
    """The 1D_SR of a batch of lines (..., n) in L-then-H order, starting
    at coordinate parity `mh`; returns the lines in sample order."""
    n = rows.shape[-1]
    i0, i1 = mh, mh + n
    n_lo = len(range(mh, n, 2))
    n_hi = len(range(1 - mh, n, 2))
    p = torch.zeros(rows.shape[:-1] + (n + 2 * _PAD + 2,), dtype=rows.dtype)
    p[..., _PAD + 2 * mh:_PAD + 2 * mh + 2 * n_lo:2] = rows[..., :n_lo]
    p[..., _PAD + 1:_PAD + 1 + 2 * n_hi:2] = rows[..., n_lo:n_lo + n_hi]
    if i1 <= i0 + 1:
        if i0 == 1:
            p[..., _PAD + 1] *= K / 2
        else:
            p[..., _PAD] *= X
    else:
        _extend(p, i0, i1)
        _lift(p, (i0 >> 1) - 1, (i1 >> 1) + 2, DELTA, 0, -1)
        _lift(p, (i0 >> 1) - 1, (i1 >> 1) + 1, GAMMA, 1, -1)
        _lift(p, i0 >> 1, (i1 >> 1) + 1, BETA, 0, 1)
        _lift(p, i0 >> 1, i1 >> 1, ALPHA, 1, 1)
    return p[..., _PAD + i0:_PAD + i1]


def inverse_dwt(planes, levels: int):
    """The inverse 9/7 of (C, H, W) planes in the deinterleaved band
    layout, at the origin: each level's rows, then its columns."""
    h, w = planes.shape[-2:]
    linelen, mod = dwtmod.dwt_levels([[0, w], [0, h]], levels)
    out = planes.clone()
    for (lh, lv), (mh, mv) in zip(linelen, mod):
        if lh <= 0 or lv <= 0:
            continue
        rows = _sr_1d(out[:, :lv, :lh], mh)
        out[:, :lv, :lh] = _sr_1d(rows.transpose(1, 2), mv).transpose(1, 2)
    return out


def decode(q: np.ndarray, step: np.ndarray, depth: int,
           dtype=DTYPE) -> np.ndarray:
    """Dequantize, inverse 9/7, inverse ICT, shift, round and clip, in
    `dtype`; the packed (H, W, 3) frame in the decoder's output format
    (samples of more than 8 bits MSB-aligned in 16)."""
    qt = torch.from_numpy(q)
    mag = qt.abs().to(dtype) + 0.5
    coef = torch.where(qt == 0, torch.zeros((), dtype=dtype),
                       torch.sign(qt).to(dtype) * mag
                       * torch.from_numpy(step).to(dtype))
    y0, y1, y2 = inverse_dwt(coef, NRESLEVELS - 1)
    rgb = torch.stack([y0 + 1.402 * y2,
                       y0 - 0.34413 * y1 - 0.71414 * y2,
                       y0 + 1.772 * y1], dim=-1)
    out = torch.round(rgb.double()) + (1 << (depth - 1))
    out = out.clamp(0, (1 << depth) - 1).numpy()
    if depth > 8:
        return out.astype(np.uint16) << (16 - depth)
    return out.astype(np.uint8)


def expected(source: np.ndarray, depth: int) -> np.ndarray:
    """The frame a float 9/7 + ICT decode of `source`'s stream returns,
    (H, W, 3)."""
    return decode(*quantized(source, depth), depth)


def lower_precision(source: np.ndarray, depth: int) -> np.ndarray:
    """The control: the source with its two lowest bits cleared. Its
    decode misses this configuration's frames by more than
    ``TOLERANCE`` where the quantization keeps those bits (the low
    bands), so it has to come out not correct."""
    return source & ~np.array(3, source.dtype)


def judge(planes, width: int, height: int, want: np.ndarray):
    """(wrong samples, the widest absolute difference) of a decoded
    frame's planes against `want`: those more than ``TOLERANCE`` off,
    and also those 1 LSB off where they are more than ``ONE_LSB_SHARE``
    of the frame. A frame of the wrong shape differs in every sample."""
    if (len(planes) != 1 or planes[0].size != want.size
            or (width, height) != (want.shape[1], want.shape[0])):
        return int(want.size), None
    diff = np.abs(planes[0].reshape(want.shape).astype(np.int64)
                  - want.astype(np.int64))
    n = int(np.count_nonzero(diff > TOLERANCE))
    near = int(np.count_nonzero(diff == TOLERANCE))
    if near > ONE_LSB_SHARE * diff.size:
        n += near
    return n, int(diff.max())
