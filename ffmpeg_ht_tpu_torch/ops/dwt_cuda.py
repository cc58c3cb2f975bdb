"""Inverse DWT levels of several planes on the card.

Two entry points run levels of the inverse DWT (5/3, integer 9/7, float
9/7; the JAX package's ``dwt_jax.dwt_decode_bands`` and
``_dwt_decode_traced``):

- ``dwt_lift_program(plan, buf)``: every level of every plane of a
  program in one call, from its input buffer: a ``V3Program``'s band
  buffer, or a ``BucketProgram``'s flat buffer, where each plane is a
  quadrant pyramid and a level's bands are corners of the plane (rows at
  the plane's stride). ``LiftPlan`` is the job table, built once per
  program; the call allocates one scratch buffer for every job's output
  and returns it (``plan.view(scratch, j)`` is job j's output).
- ``dwt_lift(jobs, transform)``: one level of at least 8x8 of a list of
  jobs, each given as tensors (the tests and ``chip_smoke.py`` compare
  level by level).

CUDA tensors launch ``csrc/dwt_small.cu`` for the levels under 8 in a
dimension (every such level of a plan in one launch, a block a plane;
they are the first levels of their planes; each lifting step updates one
parity of every line at once, in shared memory for the levels that fit
``SMALL_SHARED_BYTES`` and in device memory for the others) and then
``csrc/dwt_lift.cu``
for the others (one launch a level, 48 jobs a launch at most: a
persistent grid over tiles of ``TILE_ROWS`` x ``tile_cols(transform)``
output samples, each lifted from a window that reaches
``HALO_PAIRS[transform]`` (E, O) pairs past it on every side). CPU
tensors take the plain versions, ``dwt_torch.dwt_level_small_ref`` and
``dwt_torch.dwt_level_ref``, job by job. Empty levels (a side of 0) are
no job, as ``dwt_decode_flat`` skips them.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ffmpeg_ht_tpu_torch.ops import dwt_torch
from ffmpeg_ht_tpu_torch.ops.dwt import DWT53, DWT97, DWT97_INT
from ffmpeg_ht_tpu_torch.utils import build

# dwt_lift_launch / dwt_small_launch modes
_MODE = {DWT53: 0, DWT97_INT: 1, DWT97: 2}
MAX_JOBS = 48                 # jobs a launch (kMaxJobs in the .cu)
WINDOW_PAIRS = 128            # (E, O) pairs of a window row (kPairs)
TILE_ROWS = 32                # output rows of a tile (even; with the
                              # 9/7's halos, the kernel's 40-row window;
                              # swept on the card, tools/sweep_dwt_tiles.py)
# (E, O) pairs a window reaches past its tile on each side: each lifting
# step spoils one more sample at a window's edge, so the 5/3's two steps
# need 2 samples and the 9/7's four need 4
HALO_PAIRS = {DWT53: 1, DWT97_INT: 2, DWT97: 2}
# int64 values a job in the table (kJobInts): level, ll_out, ll, hl, lh,
# hh, out, w, h, mh, mv, preshift, ll_stride, band_stride
_JOB_INTS = 14
# a small job's row (kSmallInts): the same, then its offset in the block's
# shared memory in samples, -1 for device memory
_SMALL_INTS = 15
SMALL_SHARED_BYTES = 40960    # shared memory a dwt_small block stages its
                              # plane's levels in (kSharedBytes)
SMALL_MAX_CHAIN = 33          # small levels a plane (kMaxChain)


def tile_cols(transform: int) -> int:
    """Output columns of a tile: the window's less its two halos."""
    return 2 * WINDOW_PAIRS - 4 * HALO_PAIRS[transform]


def is_small(w: int, h: int) -> bool:
    """A level under 8 samples in a dimension: ``dwt_small``'s."""
    return w < 8 or h < 8


def _ceil_log2(n: int) -> int:
    return (n - 1).bit_length() if n > 1 else 0


def _stage(chain, itemsize: int):
    """The small job rows of one plane with their shared-memory offsets
    (a prefix of the plane's levels, while they fit SMALL_SHARED_BYTES
    together; -1 for the rest) and the staged bytes."""
    rows, off = [], 0
    for r in chain:
        n = r[7] * r[8]
        if off >= 0 and (off + n) * itemsize <= SMALL_SHARED_BYTES:
            rows.append(r + (off,))
            off += n
        else:
            rows.append(r + (-1,))
            off = -1
    return rows, sum(r[7] * r[8] for r in rows if r[-1] >= 0) * itemsize


def _split(ll, hl, lh, hh, mh, mv):
    """The level's (width, height) from its bands' (rows, cols) shapes;
    raise unless they split a level at parities mh, mv."""
    w, h = lh[1] + hl[1], hl[0] + lh[0]
    if mh not in (0, 1) or mv not in (0, 1) or tuple(ll) != (hl[0], lh[1]) \
            or tuple(hh) != (lh[0], hl[1]) \
            or lh[1] != (w + 1 - mh) // 2 or hl[0] != (h + 1 - mv) // 2:
        raise ValueError(f"bands {tuple(ll)}, {tuple(hl)}, {tuple(lh)}, "
                         f"{tuple(hh)} do not split a level at parities "
                         f"({mh}, {mv})")
    return w, h


def _row_stride(t):
    """A 2-D tensor's row stride, None when it has one row or no sample
    (any stride fits it)."""
    return t.stride(0) if t.shape[0] > 1 and t.numel() else None


def _strides(ll, hl, lh, hh):
    """(ll_stride, band_stride) of a job's table row from its bands'
    (rows, cols, row stride): the LL's stride and the one HL, LH and HH
    share, 0 where a band's own width will do (a band of one row or none
    takes any stride). Raises when HL, LH and HH have different strides
    that are not their own widths."""
    ll_rows, ll_cols, ll_s = ll
    lls = 0 if ll_s is None or ll_s == ll_cols else ll_s
    rows = [(s, cols) for _r, cols, s in (hl, lh, hh) if s is not None]
    if all(s == cols for s, cols in rows):
        return lls, 0
    if len({s for s, _c in rows}) == 1:
        return lls, rows[0][0]
    raise ValueError("HL, LH and HH must share a row stride")


def _dtype(transform: int):
    if transform not in _MODE:
        raise ValueError(f"unknown transform {transform}")
    return torch.float32 if transform == DWT97 else torch.int32


class LiftPlan:
    """Every inverse DWT level of a program's planes as the kernels' job
    tables, built once per program.

    `band_offsets` / `band_shapes` give each band of the input buffer:
    its first sample and its (rows, cols), row-major at the row stride of
    `band_strides` (None: each band's own width, as in a ``CoefLayout``'s
    band buffer); `buffer_size` is the input buffer's length (None: the
    bands' total). `planes` lists, per plane, ``(ll_band, [(hl, lh, hh)
    band indices a level], [(mh, mv) a level])``. A job's LL is its
    plane's LL band on its first level, else its previous job's output;
    the integer 9/7's final shift rides on each plane's last level. An
    empty level (a side of 0) is no job: its LL and the next level's are
    empty too. Levels under 8 in a dimension go to ``small_table`` (grouped
    by plane, ``small_chains`` the row where each plane's start, then the
    end; a row is a job's ``table`` row and its offset in ``dwt_small``'s
    shared memory, -1 for device memory: a prefix of each plane's levels
    that fits ``SMALL_SHARED_BYTES``, ``small_shared`` jobs of them,
    ``small_device`` the others, ``small_smem`` the bytes a block stages)
    and run first; the others to ``table``, level by level (every plane's
    level 0, then every plane's level 1, ...). ``jobs[i]`` is ``(plane,
    level, w, h)``, ``last[p]`` plane p's last job (None for a plane
    without levels); ``lift_launches`` and ``small_launches`` are each
    kernel's launches in one call, ``launches`` both."""

    def __init__(self, band_offsets, band_shapes, planes, transform: int,
                 band_strides=None, buffer_size=None):
        _dtype(transform)
        self.transform = transform
        shapes = [tuple(s) for s in band_shapes]
        strides = [c for _r, c in shapes] if band_strides is None \
            else list(band_strides)
        self.band_total = sum(r * c for r, c in shapes) \
            if buffer_size is None else buffer_size
        big, small, self.jobs, self.out_offsets = [], {}, [], []
        self.last = [None] * len(planes)
        pos, per_level = 0, {}

        def band(b):
            r, c = shapes[b]
            return r, c, strides[b] if r > 1 and c else None

        for lev in range(max((len(p[1]) for p in planes), default=0)):
            for i, (ll_band, lvls, mods) in enumerate(planes):
                if lev >= len(lvls):
                    continue
                hl, lh, hh = lvls[lev]
                mh, mv = mods[lev]
                (nEv, nO), (nOv, nE) = shapes[hl], shapes[lh]
                prev = self.last[i]
                if prev is None:
                    ll_out, ll_off = 0, band_offsets[ll_band]
                    ll = band(ll_band)
                    if not nE * nEv:           # an empty LL, as it must be
                        ll = (nEv, nE, None)   # after an empty level
                else:
                    _p, _l, pw, ph = self.jobs[prev]
                    ll_out, ll_off, ll = 1, self.out_offsets[prev], \
                        (ph, pw, None)
                w, h = _split(ll[:2], shapes[hl], shapes[lh], shapes[hh], mh,
                              mv)
                if not w * h:
                    continue
                ll_s, band_s = _strides(ll, band(hl), band(lh), band(hh))
                pre = transform == DWT97_INT and lev == len(lvls) - 1
                row = (lev, ll_out, ll_off, band_offsets[hl],
                       band_offsets[lh], band_offsets[hh], pos, w, h, mh, mv,
                       int(pre), ll_s, band_s)
                if is_small(w, h):
                    if prev is not None and not is_small(*self.jobs[prev][2:]):
                        raise ValueError(f"plane {i}: a {w}x{h} level after "
                                         "one of at least 8x8")
                    if max(h << _ceil_log2(w), w << _ceil_log2(h)) >= 1 << 31:
                        raise ValueError(f"a {w}x{h} level is too large for "
                                         "dwt_small")
                    small.setdefault(i, []).append(row)
                else:
                    big.append(row)
                    per_level[lev] = per_level.get(lev, 0) + 1
                self.last[i] = len(self.jobs)
                self.jobs.append((i, lev, w, h))
                self.out_offsets.append(pos)
                pos += w * h
        self.total = pos
        self.table = np.array(big, np.int64).reshape(-1, _JOB_INTS)
        chains = [small[i] for i in sorted(small)]
        if any(len(c) > SMALL_MAX_CHAIN for c in chains):
            raise ValueError(f"a plane of more than {SMALL_MAX_CHAIN} "
                             "levels under 8x8")
        itemsize = _dtype(transform).itemsize
        staged = [_stage(c, itemsize) for c in chains]
        self.small_table = np.array([r for c, _b in staged for r in c],
                                    np.int64).reshape(-1, _SMALL_INTS)
        self.small_chains = np.cumsum([0] + [len(c) for c in chains]) \
            .astype(np.int64)
        self.small_shared = int((self.small_table[:, 14] >= 0).sum())
        self.small_device = len(self.small_table) - self.small_shared
        self.small_smem = max((b for _c, b in staged), default=0)
        self.small_maxchain = max((len(c) for c in chains), default=0)
        self.lift_launches = sum(-(-n // MAX_JOBS) for n in per_level.values())
        self.small_launches = int(bool(chains))
        self.launches = self.lift_launches + self.small_launches
        self._small_on = {}

    def small_table_on(self, device):
        """``small_table`` as ``dwt_small`` reads it, an int64 tensor on
        `device` (uploaded once): ``small_maxchain`` rows a plane, plane
        b's levels from row b * small_maxchain, zero rows after them."""
        t = self._small_on.get(device)
        if t is None:
            nplanes = len(self.small_chains) - 1
            pad = np.zeros((nplanes, self.small_maxchain, _SMALL_INTS),
                           np.int64)
            for b in range(nplanes):
                lo, hi = self.small_chains[b:b + 2]
                pad[b, :hi - lo] = self.small_table[lo:hi]
            t = torch.from_numpy(pad.reshape(-1, _SMALL_INTS)).to(device)
            self._small_on[device] = t
        return t

    def view(self, scratch, j: int):
        """Job j's output, an (h, w) view of a call's scratch buffer."""
        _i, _l, w, h = self.jobs[j]
        return scratch.as_strided((h, w), (w, 1),
                                  scratch.storage_offset()
                                  + self.out_offsets[j])


def _launch(plan: LiftPlan, base: int, out):
    """Launch ``dwt_lift`` on every job of `plan.table`: inputs at element
    offsets from the address `base`, outputs into `out`. Adds the
    launches made to ``dwt_lift.launches``."""
    t = plan.transform
    n = ctypes.c_int(0)
    with torch.cuda.device(out.device):
        err = build.load().lib.dwt_lift_launch(
            plan.table.ctypes.data, len(plan.table), base, out.data_ptr(),
            _MODE[t], TILE_ROWS, tile_cols(t), HALO_PAIRS[t],
            torch.cuda.current_stream(out.device).cuda_stream,
            ctypes.addressof(n))
    build.check(err, "dwt_lift_launch")
    dwt_lift.launches += n.value


def dwt_small(plan: LiftPlan, base: int, out):
    """Launch ``dwt_small`` once on `plan`'s small jobs (its
    ``small_table_on`` the device): inputs at element offsets from the
    address `base`, outputs into `out`. ``dwt_lift_program`` is the entry
    point that checks a plan's buffer; this is its launch, which
    ``chip_smoke.py`` times alone."""
    table = plan.small_table_on(out.device)
    with torch.cuda.device(out.device):
        err = build.load().lib.dwt_small_launch(
            table.data_ptr(), len(plan.small_chains) - 1,
            plan.small_maxchain, plan.small_smem, base, out.data_ptr(),
            _MODE[plan.transform],
            torch.cuda.current_stream(out.device).cuda_stream)
    build.check(err, "dwt_small_launch")
    dwt_small.launches += 1


def _check_bands(plan: LiftPlan, bands):
    dtype = _dtype(plan.transform)
    if bands.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {bands.device}")
    if bands.dtype != dtype:
        raise TypeError(f"bands have dtype {bands.dtype}, expected {dtype}")
    if bands.dim() != 1 or not bands.is_contiguous() \
            or bands.numel() != plan.band_total:
        raise ValueError(f"bands must be a contiguous 1-D tensor of "
                         f"{plan.band_total} samples")


def _rows(buf, off: int, rows: int, cols: int, stride: int):
    """(rows, cols) samples of the 1-D `buf` from `off`, rows `stride`
    apart."""
    if not rows * cols:
        return buf.new_zeros((rows, cols))
    return buf.as_strided((rows, cols), (stride, 1),
                          buf.storage_offset() + off)


def dwt_lift_program_ref(plan: LiftPlan, bands):
    """Plain PyTorch version of ``dwt_lift_program``: the small levels
    (``dwt_level_small_ref``), then the others (``dwt_level_ref``), job
    by job, each output copied into the scratch buffer."""
    _check_bands(plan, bands)
    scratch = torch.empty(plan.total, dtype=bands.dtype, device=bands.device)
    for (_lev, ll_out, ll, hl, lh, hh, o, w, h, mh, mv, pre, lls, bs) in \
            [r[:_JOB_INTS] for r in plan.small_table.tolist()] \
            + plan.table.tolist():
        nE, nEv = (w + 1 - mh) // 2, (h + 1 - mv) // 2
        nO, nOv = w - nE, h - nEv
        ref = dwt_torch.dwt_level_small_ref if is_small(w, h) \
            else dwt_torch.dwt_level_ref
        scratch[o:o + w * h].view(h, w).copy_(ref(
            _rows(scratch if ll_out else bands, ll, nEv, nE, lls or nE),
            _rows(bands, hl, nEv, nO, bs or nO),
            _rows(bands, lh, nOv, nE, bs or nE),
            _rows(bands, hh, nOv, nO, bs or nO), mh, mv, plan.transform,
            bool(pre)))
    return scratch


def dwt_lift_program(plan: LiftPlan, bands):
    """Every job of `plan` on the input buffer `bands` (1-D, contiguous,
    int32; float32 for DWT97): returns one scratch buffer that holds
    every job's output (``plan.view(scratch, j)``). A CUDA tensor takes
    one ``dwt_small`` launch for the levels under 8 in a dimension, then
    one ``dwt_lift`` launch a level; a CPU tensor the plain version."""
    _check_bands(plan, bands)
    if bands.device.type == "cpu":
        return dwt_lift_program_ref(plan, bands)
    scratch = torch.empty(plan.total, dtype=bands.dtype, device=bands.device)
    if len(plan.small_table):
        dwt_small(plan, bands.data_ptr(), scratch)
    if len(plan.table):
        _launch(plan, bands.data_ptr(), scratch)
    return scratch


def _job_rows(jobs, transform: int):
    """The table rows of jobs given as tensors, ``(ll, hl, lh, hh, mh, mv,
    preshift)``: 2-D bands of rows (unit column stride) of one dtype on
    one device. Inputs are element offsets from the first non-empty band,
    outputs back to back from 0. Raises unless every job is a level of
    at least 8x8. Returns (rows, dims, base address)."""
    dtype = _dtype(transform)
    dev = jobs[0][0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    bands = [t for j in jobs for t in j[:4]]
    for t in bands:
        if t.device != dev:
            raise ValueError(f"a band on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"a band has dtype {t.dtype}, expected {dtype}")
        if t.dim() != 2 or t.numel() and (
                (t.shape[1] > 1 and t.stride(1) != 1)
                or (t.shape[0] > 1 and t.stride(0) < t.shape[1])):
            raise ValueError("bands must be 2-D rows of unit column stride")
    live = [t for t in bands if t.numel()]
    base = live[0].data_ptr() if live else 0
    size = dtype.itemsize
    rows, dims, pos = [], [], 0
    for ll, hl, lh, hh, mh, mv, pre in jobs:
        w, h = _split(ll.shape, hl.shape, lh.shape, hh.shape, mh, mv)
        if not w * h:
            raise ValueError(f"a {w}x{h} level is empty")
        if is_small(w, h):
            raise ValueError(
                f"a {w}x{h} level is below 8x8: a LiftPlan's small job "
                "(the line-buffer branch of dwt_decode_flat)")
        if pre and transform != DWT97_INT:
            raise ValueError("preshift belongs to the integer 9/7")
        off = [(t.data_ptr() - base) // size if t.numel() else 0
               for t in (ll, hl, lh, hh)]
        rows.append((0, 0, *off, pos, w, h, mh, mv, int(pre),
                     *_strides(*((t.shape[0], t.shape[1], _row_stride(t))
                                 for t in (ll, hl, lh, hh)))))
        dims.append((w, h))
        pos += w * h
    return np.array(rows, np.int64).reshape(-1, _JOB_INTS), dims, base


def _outputs(scratch, dims):
    out, pos = [], 0
    for w, h in dims:
        out.append(scratch[pos:pos + w * h].view(h, w))
        pos += w * h
    return out


def dwt_lift(jobs, transform: int):
    """One inverse DWT level of at least 8x8 of each job; returns their
    next LLs, (h, w) tensors in job order.

    A job is ``(ll, hl, lh, hh, mh, mv, preshift)``: the previous LL and
    the level's HL, LH and HH (2-D rows, int32; float32 for DWT97; HL,
    LH and HH at one row stride or each contiguous), the level's origin
    parities, and whether the integer 9/7's final rounding shift follows
    (its last level). All jobs lie on one device."""
    jobs = [tuple(j) for j in jobs]
    if not jobs:
        return []
    table, dims, base = _job_rows(jobs, transform)
    if jobs[0][0].device.type == "cpu":
        return [dwt_torch.dwt_level_ref(*j[:6], transform, bool(j[6]))
                for j in jobs]
    plan = LiftPlan([], [], [], transform)
    plan.table = table
    plan.total = sum(w * h for w, h in dims)
    scratch = torch.empty(plan.total, dtype=_dtype(transform),
                          device=jobs[0][0].device)
    _launch(plan, base, scratch)
    return _outputs(scratch, dims)


dwt_lift.launches = 0    # kernel launches: one a level of <= 48 jobs
dwt_small.launches = 0   # kernel launches: one a dwt_lift_program call
                         # with small levels
