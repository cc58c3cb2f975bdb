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

``bucket_scatter`` does the same for the v2 ``BucketProgram``
(``ffmpeg_ht_tpu.models.decoder._compiled_assembly``, decoder.py:
481-519): the dequant of every bucket's mu words and their scatter into
one flat coefficient buffer (each tile-component plane's quadrant
pyramid) after the sparse prefill. CPU tensors take
``bucket_scatter_ref`` (``dequant`` and index puts, the program's torch
ops before); CUDA tensors launch ``csrc/bucket_scatter.cu`` (one lane
pass each ``MAX_BUCKETS`` buckets, which marks the samples it writes in a
bitmap, then zeros where no lane wrote, then the prefill where no lane
wrote). A ``ScatterPlan``, built once per bucket layout, holds the launch
table's shapes, so that a call fills in only the tensors' addresses.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ffmpeg_ht_tpu_torch.ops.dwt import DWT53, DWT97, DWT97_INT
from ffmpeg_ht_tpu_torch.utils import build
from ffmpeg_ht_tpu_torch.utils.device import check_tensor

# coef_mosaic_launch modes
_MODE = {DWT53: 0, DWT97_INT: 1, DWT97: 2}
MAX_BUCKETS = 48              # buckets a bucket_scatter launch (kMaxBuckets)


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

    def view(self, buf, b: int):
        """Band b of a band buffer, a (bh, bw) view."""
        (h, w), o = self.shapes[b], self.offsets[b]
        return buf[o:o + h * w].view(h, w)


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


_LANE_VECTORS = (("dest", torch.int32), ("stride", torch.int32),
                 ("magb", torch.int32), ("istep", torch.int32),
                 ("scale97", torch.int32), ("fscale", torch.float32))


def bucket_scatter_ref(mus, dims, lanes, pf_idx, pf_val, total: int,
                       transform: int, no_istep: bool):
    """Plain PyTorch version of ``bucket_scatter``: zeros, the prefill,
    then each bucket's lanes dequantized and put at ``dest + y * stride +
    x``, pad lanes and samples outside a codeblock into the trailing trash
    slot, which is cleared last."""
    dt = torch.float32 if transform == DWT97 else torch.int32
    flat = torch.zeros(total + 1, dtype=dt, device=pf_idx.device)
    flat[pf_idx.long()] = pf_val.to(dt)
    for mu, (w, h), a in zip(mus, dims, lanes):
        coef = dequant(mu, a["magb"], a["istep"], a["scale97"], a["fscale"],
                       transform, no_istep)
        y = torch.arange(mu.shape[1], device=mu.device)[None, :, None]
        x = torch.arange(mu.shape[2], device=mu.device)[None, None, :]
        base = a["dest"].long()[:, None, None]
        idx = base + y * a["stride"].long()[:, None, None] + x
        idx = torch.where((base < 0) | (y >= h) | (x >= w), total, idx)
        flat[idx.reshape(-1)] = coef.reshape(-1).to(dt)
    flat[total] = 0
    return flat


def _check(t, name, dtype, dev, didx, shape):
    """check_tensor for a tensor of a known shape, fast when it passes
    (`didx`: `dev` as ``Tensor.get_device()`` numbers it)."""
    if t.dtype is not dtype or t.get_device() != didx or t.shape != shape \
            or not t.is_contiguous():
        check_tensor(t, name, dtype, dev, len(shape), shape[0])
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


class ScatterPlan:
    """``bucket_scatter``'s launch table for one bucket layout, built once
    (a ``BucketProgram`` holds one): each bucket's raster ``(bh, bw)`` and
    codeblock ``(w, h)``, checked here, in the table's shape columns (the
    kernel's row: mu, dest, stride, magb, istep, scale97, fscale
    addresses, then n, bh, bw, h, w). ``fill`` checks a call's tensors and
    writes their addresses and lane counts."""

    def __init__(self, rasters, dims):
        self.rasters = [tuple(r) for r in rasters]
        self.dims = [tuple(d) for d in dims]
        if len(self.rasters) != len(self.dims):
            raise ValueError("one raster and one (w, h) a bucket")
        for (bh, bw), (w, h) in zip(self.rasters, self.dims):
            if not (0 <= w <= bw and 0 <= h <= bh):
                raise ValueError(f"a {w}x{h} codeblock in a {bw}x{bh} "
                                 "raster")
        self.table = np.zeros((len(self.dims), 12), np.int64)
        if len(self.dims):
            self.table[:, 8:10] = self.rasters
            self.table[:, 10] = [h for _w, h in self.dims]
            self.table[:, 11] = [w for w, _h in self.dims]

    def fill(self, mus, lanes, dev):
        """The launch table with the addresses and lane counts of `mus`
        and `lanes` (on `dev`); raises on a tensor of another dtype,
        device or shape, or not contiguous."""
        if not len(mus) == len(lanes) == len(self.dims):
            raise ValueError("one mu, one (w, h) and one lane map a bucket")
        didx = -1 if dev.type == "cpu" else dev.index
        cols = []
        for mu, a, (bh, bw) in zip(mus, lanes, self.rasters):
            n = mu.shape[0] if mu.dim() else 0
            _check(mu, "mu", torch.int32, dev, didx, (n, bh, bw))
            row = [mu.data_ptr()]
            for name, dt in _LANE_VECTORS:
                t = a[name]
                _check(t, name, dt, dev, didx, (n,))
                row.append(t.data_ptr())
            row.append(n)
            cols.append(row)
        if cols:
            self.table[:, :8] = cols
        return self.table


def bucket_scatter(mus, dims, lanes, pf_idx, pf_val, total: int,
                   transform: int, no_istep: bool, plan=None):
    """The flat coefficient buffer of a v2 program: ``total + 1`` samples
    (int32; float32 for DWT97), the last one a trash slot that reads 0.

    `mus` holds each bucket's (N, bh, bw) int32 mu words, `dims` its
    codeblocks' (w, h) (at most (bw, bh)), `lanes` its lane vectors
    (a mapping with "dest", "stride", "magb", "istep", "scale97": N
    int32, "fscale": N float32; a pad lane has dest < 0); `pf_idx` (int32,
    ``total`` for a pad) and `pf_val` (the buffer's dtype) the prefill.
    Lane samples win over prefill entries where they meet. `plan` is the
    layout's ``ScatterPlan`` (built here when None). A CUDA tensor takes
    one call of the kernel's entry point (one lane launch each MAX_BUCKETS
    buckets, counted; the zeros and the prefill ride on the call); a CPU
    tensor the plain version."""
    if transform not in _MODE:
        raise ValueError(f"unknown transform {transform}")
    dev = pf_idx.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    dtype = torch.float32 if transform == DWT97 else torch.int32
    check_tensor(pf_idx, "pf_idx", torch.int32, dev, 1, pf_idx.shape[0])
    check_tensor(pf_val, "pf_val", dtype, dev, 1, pf_idx.shape[0])
    if plan is None:
        plan = ScatterPlan([tuple(m.shape[1:]) for m in mus], dims)
    elif list(map(tuple, dims)) != plan.dims:
        raise ValueError("dims differ from the plan's")
    table = plan.fill(mus, lanes, dev)
    if dev.type == "cpu":
        return bucket_scatter_ref(mus, dims, lanes, pf_idx, pf_val, total,
                                  transform, no_istep)
    out = torch.empty(total + 1, dtype=dtype, device=dev)
    bits = torch.empty((total + 32) // 32, dtype=torch.int32, device=dev)
    n = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = build.load().lib.bucket_scatter_launch(
            table.ctypes.data, len(table), pf_idx.data_ptr(),
            pf_val.data_ptr(), pf_idx.shape[0], total, _MODE[transform],
            int(no_istep), out.data_ptr(), bits.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream, ctypes.addressof(n))
    build.check(err, "bucket_scatter_launch")
    bucket_scatter.launches += n.value
    return out


def bucket_scatter_launches(nbuckets: int) -> int:
    """The launches ``bucket_scatter`` counts for `nbuckets` buckets with
    lanes: one each MAX_BUCKETS."""
    return -(-nbuckets // MAX_BUCKETS)


bucket_scatter.launches = 0   # lane-pass launches (one a MAX_BUCKETS
                              # buckets; the bitmap's memset, the zeros and
                              # the prefill ride on the call)
