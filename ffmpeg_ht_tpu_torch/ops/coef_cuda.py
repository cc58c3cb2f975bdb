"""Dequant, prefill and band mosaic of the v3 device program's coefficients.

``coef_mosaic`` computes, for every frame of a ``V3Program``, what the JAX
package's v3 program computes between the HT cleanup and the inverse DWT
(``ffmpeg_ht_tpu.models.assembly``, assembly.py:326-357 and
``_mosaic_band`` at :200): the dequant of the mu words, the sparse
prefill of host-decoded lanes, and every subband (LL, and HL, LH, HH of
each level) of every plane cut out of the lane rasters. The bands are
written back to back into one buffer whose layout, a ``CoefLayout``, is
built once per program from its ``AssemblyPlan``.

CPU tensors take the plain version ``coef_mosaic_ref``: ``dequant``, then
``prefill`` into the lane rasters, then ``mosaic_band`` for each band (the
slice / reshape / permute / cat torch ops the program ran before), the
bands concatenated. CUDA tensors launch ``csrc/coef_mosaic.cu`` (one
mosaic launch, then one prefill launch) and nothing else.
``dequant``, ``prefill`` and ``mosaic_band`` also serve the programs'
other routes: the v2 ``BucketProgram`` and the flat-DWT fallback.
"""

from __future__ import annotations

import numpy as np
import torch

from ffmpeg_ht_tpu_torch.ops.dwt import DWT53, DWT97, DWT97_INT
from ffmpeg_ht_tpu_torch.utils import build
from ffmpeg_ht_tpu_torch.utils.device import check_tensor

# coef_mosaic_launch modes
_MODE = {DWT53: 0, DWT97_INT: 1, DWT97: 2}


def dequant(mu, magb, istep, scale97, fscale, transform: int,
            no_istep: bool):
    """Lane rasters of coefficients from the int32 bits of the uint32 mu
    words (bit 31 sign), as assembly.py:327-349 computes them: reversible
    (5/3, ``magb`` and ``istep``), integer 9/7 (Q16 ``scale97``, int64
    products) or float 9/7 (``fscale``, float32 rasters)."""
    neg = mu < 0
    mag = mu & 0x7FFFFFFF
    if transform == DWT97:
        return torch.where(neg, -mag, mag).to(torch.float32) \
            * fscale[:, None, None]
    if transform == DWT97_INT:
        m = torch.where(neg, -mag, mag)
        m = ((m + 32) >> 6).to(torch.int64)
        prod = m * scale97[:, None, None].to(torch.int64)
        coef = torch.where(prod > 0, (prod + (1 << 15)) >> 16,
                           (prod + (1 << 15) - 1) >> 16)
        return coef.to(torch.int32)
    # reversible: every step stays non-negative int32
    m = mag >> (31 - magb)[:, None, None]
    coef = torch.where(neg, -m, m)
    if not no_istep:
        st = istep[:, None, None]
        coef = torch.where(st != 32768, (coef * st) >> 16, coef)
    return coef


def prefill(coef, pf_idx, pf_val):
    """Host-decoded lanes scattered into the lane rasters `coef`; pad
    entries address a trailing trash slot, which is sliced off."""
    flat = torch.cat([coef.reshape(-1), coef.new_zeros(1)])
    flat[pf_idx.long()] = pf_val.to(flat.dtype)
    return flat[:-1].view(coef.shape)


def mosaic_band(ras, bp, lane_off: int):
    """One subband (a ``BandPlan``) from the lane rasters
    (assembly.py:200-221)."""
    if bp.bw == 0 or bp.bh == 0 or not bp.rows:
        return ras.new_zeros((bp.bh, bp.bw))
    row_rects = []
    for row in bp.rows:
        rects = []
        for pp in row:
            lo = lane_off + pp.l0
            sub = ras[lo:lo + pp.ch * pp.cw, :pp.blk_h, :pp.blk_w]
            g = sub.reshape(pp.ch, pp.cw, pp.blk_h, pp.blk_w) \
                .permute(0, 2, 1, 3) \
                .reshape(pp.ch * pp.blk_h, pp.cw * pp.blk_w)
            rects.append(g[:pp.ph, :pp.pw])
        row_rects.append(rects[0] if len(rects) == 1
                         else torch.cat(rects, 1))
    return row_rects[0] if len(row_rects) == 1 else torch.cat(row_rects, 0)


class CoefLayout:
    """Where every lane's raster lands in one band buffer.

    `bands` lists ``(BandPlan, lane_off)`` in buffer order: band b holds
    ``shapes[b]`` samples row-major from ``offsets[b]``, cut from the
    lanes ``lane_off + pp.l0 ...`` of its precincts. ``table`` has six
    int64 values a lane (``n_lanes`` of ``bh`` x ``bw`` rasters): its
    band's offset and width, the codeblock's origin (by0, bx0) in the
    band, and its height and width after the precinct crop, 0 x 0 for a
    lane of no band. The lanes must cover every sample of every band (as
    ``build_plan``'s precinct grids do; a band without precincts has no
    samples), so the kernel writes each sample once and needs no zero
    fill; a layout whose lanes leave a sample out raises ValueError."""

    def __init__(self, bands, n_lanes: int, bh: int, bw: int):
        self.bands = list(bands)
        self.n_lanes, self.bh, self.bw = n_lanes, bh, bw
        self.shapes = [(bp.bh, bp.bw) for bp, _off in self.bands]
        ends = np.cumsum([0] + [h * w for h, w in self.shapes])
        self.offsets = [int(o) for o in ends[:-1]]
        self.total = int(ends[-1])
        table = np.zeros((n_lanes, 6), np.int64)
        for (bp, lane_off), off in zip(self.bands, self.offsets):
            by = 0
            for row in bp.rows:
                bx = 0
                for pp in row:
                    n = pp.ch * pp.cw
                    i, j = np.divmod(np.arange(n), pp.cw)
                    table[lane_off + pp.l0 + np.arange(n)] = np.stack([
                        np.full(n, off), np.full(n, bp.bw),
                        by + i * pp.blk_h, bx + j * pp.blk_w,
                        np.minimum(pp.blk_h, pp.ph - i * pp.blk_h),
                        np.minimum(pp.blk_w, pp.pw - j * pp.blk_w)], 1)
                    bx += pp.pw
                by += row[0].ph
        if int((table[:, 4] * table[:, 5]).sum()) != self.total:
            raise ValueError("the lanes do not cover the bands")
        self.table = table
        self._tables = {}

    def table_on(self, device):
        """The map table as an int64 tensor on `device` (uploaded once)."""
        t = self._tables.get(device)
        if t is None:
            t = torch.from_numpy(self.table).to(device)
            self._tables[device] = t
        return t

    def views(self, buf):
        """The bands of a band buffer, as (bh, bw) views in layout order."""
        return [buf[o:o + h * w].view(h, w)
                for o, (h, w) in zip(self.offsets, self.shapes)]


def coef_mosaic_ref(mu, magb, istep, scale97, fscale, pf_idx, pf_val,
                    layout: CoefLayout, transform: int, no_istep: bool):
    """Plain PyTorch version of ``coef_mosaic``: the dequant, the prefill
    and the band mosaics as torch ops, the bands concatenated."""
    coef = prefill(dequant(mu, magb, istep, scale97, fscale, transform,
                           no_istep), pf_idx, pf_val)
    return torch.cat([mosaic_band(coef, bp, off).reshape(-1)
                      for bp, off in layout.bands])


def coef_mosaic(mu, magb, istep, scale97, fscale, pf_idx, pf_val,
                layout: CoefLayout, transform: int, no_istep: bool):
    """Every band of `layout` from the mu words of its lanes: a 1-D
    buffer of ``layout.total`` samples (int32; float32 for DWT97), band b
    at ``layout.offsets[b]``.

    `mu` is the cleanup's (n_lanes, bh, bw) int32 words; `magb`, `istep`,
    `scale97` (int32) and `fscale` (float32) one value a lane; `pf_idx`
    (int32) indexes the lane rasters, one past their end for a pad, and
    `pf_val` holds the samples (the buffer's dtype). A CUDA tensor takes
    one launch of the kernel (mosaic, then prefill); a CPU tensor the
    plain version."""
    if transform not in _MODE:
        raise ValueError(f"unknown transform {transform}")
    dev = mu.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    N, bh, bw = layout.n_lanes, layout.bh, layout.bw
    dtype = torch.float32 if transform == DWT97 else torch.int32
    check_tensor(mu, "mu", torch.int32, dev, 3, N)
    if tuple(mu.shape) != (N, bh, bw):
        raise ValueError(f"mu has shape {tuple(mu.shape)}, expected "
                         f"{(N, bh, bw)}")
    for name, t, dt in (("magb", magb, torch.int32),
                        ("istep", istep, torch.int32),
                        ("scale97", scale97, torch.int32),
                        ("fscale", fscale, torch.float32)):
        check_tensor(t, name, dt, dev, 1, N)
    check_tensor(pf_idx, "pf_idx", torch.int32, dev, 1, pf_idx.shape[0])
    check_tensor(pf_val, "pf_val", dtype, dev, 1, pf_idx.shape[0])
    if dev.type == "cpu":
        return coef_mosaic_ref(mu, magb, istep, scale97, fscale, pf_idx,
                               pf_val, layout, transform, no_istep)
    out = torch.empty(layout.total, dtype=dtype, device=dev)
    table = layout.table_on(dev)
    with torch.cuda.device(dev):
        err = build.load().lib.coef_mosaic_launch(
            mu.data_ptr(), table.data_ptr(), magb.data_ptr(),
            istep.data_ptr(), scale97.data_ptr(), fscale.data_ptr(), N, bh,
            bw, _MODE[transform], int(no_istep), pf_idx.data_ptr(),
            pf_val.data_ptr(), pf_idx.shape[0], out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "coef_mosaic_launch")
    coef_mosaic.launches += 1
    return out


coef_mosaic.launches = 0   # calls that launched the kernel (mosaic, then
                           # prefill)
