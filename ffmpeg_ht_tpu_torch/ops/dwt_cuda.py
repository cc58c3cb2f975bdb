"""Band-direct inverse DWT levels of several planes on the card.

Two entry points run levels of ``dwt_torch.dwt_decode_bands`` (5/3,
integer 9/7, float 9/7; the JAX package's ``dwt_jax.dwt_decode_bands``):

- ``dwt_lift_program(plan, bands)``: every level of every plane of a
  ``V3Program`` in one call, from its band buffer. ``LiftPlan`` is the job
  table, built once per program; the call allocates one scratch buffer
  for every job's output and returns it (``plan.view(scratch, j)`` is job
  j's output).
- ``dwt_lift(jobs, transform)``: one level of a list of jobs, each given
  as tensors (the tests and ``chip_smoke.py`` compare level by level).

CUDA tensors launch ``csrc/dwt_lift.cu`` (one launch a level, 48 jobs a
launch at most: a persistent grid over tiles of ``TILE_ROWS`` x
``tile_cols(transform)`` output samples, each lifted from a window that
reaches ``HALO_PAIRS[transform]`` (E, O) pairs past it on every side);
CPU tensors take the plain version, ``dwt_torch.dwt_level_ref``, job by
job. Levels below 8x8 belong to the flat fallback
(``dwt_torch.dwt_decode_flat``) and raise on either device.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ffmpeg_ht_tpu_torch.ops import dwt_torch
from ffmpeg_ht_tpu_torch.ops.dwt import DWT53, DWT97, DWT97_INT
from ffmpeg_ht_tpu_torch.utils import build

# dwt_lift_launch modes
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
_JOB_INTS = 12                # int64 values a job in the table (kJobInts)


def tile_cols(transform: int) -> int:
    """Output columns of a tile: the window's less its two halos."""
    return 2 * WINDOW_PAIRS - 4 * HALO_PAIRS[transform]


def _split(ll, hl, lh, hh, mh, mv):
    """The level's (width, height) from its bands' (rows, cols) shapes;
    raise unless they split a level of at least 8x8 at parities mh, mv."""
    w, h = ll[1] + hl[1], ll[0] + lh[0]
    if mh not in (0, 1) or mv not in (0, 1) or hl[0] != ll[0] \
            or lh[1] != ll[1] or tuple(hh) != (lh[0], hl[1]) \
            or ll[1] != (w + 1 - mh) // 2 or ll[0] != (h + 1 - mv) // 2:
        raise ValueError(f"bands {tuple(ll)}, {tuple(hl)}, {tuple(lh)}, "
                         f"{tuple(hh)} do not split a level at parities "
                         f"({mh}, {mv})")
    if w < 8 or h < 8:
        raise ValueError(f"a {w}x{h} level is below 8x8: use "
                         "dwt_decode_flat")
    return w, h


def _check_job(job, dtype, device, transform):
    """Raise unless `job` is (ll, hl, lh, hh, mh, mv, preshift) of one
    band-direct level: contiguous 2-D `dtype` bands on `device` whose
    shapes split a level of at least 8x8 at parities mh, mv. Returns the
    level's (width, height)."""
    ll, hl, lh, hh, mh, mv, pre = job
    for name, t in (("ll", ll), ("hl", hl), ("lh", lh), ("hh", hh)):
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor")
    if pre and transform != DWT97_INT:
        raise ValueError("preshift belongs to the integer 9/7")
    return _split(ll.shape, hl.shape, lh.shape, hh.shape, mh, mv)


def _dtype(transform: int):
    if transform not in _MODE:
        raise ValueError(f"unknown transform {transform}")
    return torch.float32 if transform == DWT97 else torch.int32


class LiftPlan:
    """Every band-direct level of a program's planes as the kernel's job
    table, built once per program.

    `band_offsets` / `band_shapes` give each band of the band buffer (a
    ``CoefLayout``'s ``offsets`` and ``shapes``); `planes` lists, per
    plane, ``(ll_band, [(hl, lh, hh) band indices a level], [(mh, mv) a
    level])``. The jobs run level by level (every plane's level 0, then
    every plane's level 1, ...); a job's LL is its plane's LL band on
    level 0, else its previous job's output, and the integer 9/7's final
    shift rides on each plane's last level. ``jobs[i]`` is ``(plane,
    level, w, h)``, ``last[p]`` plane p's last job (None for a plane
    without levels), ``launches`` the kernel launches of one call."""

    def __init__(self, band_offsets, band_shapes, planes, transform: int):
        _dtype(transform)
        self.transform = transform
        self.band_total = sum(h * w for h, w in band_shapes)
        rows, self.jobs, self.out_offsets = [], [], []
        self.last = [None] * len(planes)
        pos, per_level = 0, []
        for lev in range(max((len(p[1]) for p in planes), default=0)):
            per_level.append(0)
            for i, (ll_band, lvls, mods) in enumerate(planes):
                if lev >= len(lvls):
                    continue
                hl, lh, hh = lvls[lev]
                mh, mv = mods[lev]
                prev = self.last[i]
                if prev is None:
                    ll_out, ll_off = 0, band_offsets[ll_band]
                    ll_shape = band_shapes[ll_band]
                else:
                    _p, _l, pw, ph = self.jobs[prev]
                    ll_out, ll_off, ll_shape = 1, self.out_offsets[prev], \
                        (ph, pw)
                w, h = _split(ll_shape, band_shapes[hl], band_shapes[lh],
                              band_shapes[hh], mh, mv)
                pre = transform == DWT97_INT and lev == len(lvls) - 1
                rows.append((lev, ll_out, ll_off, band_offsets[hl],
                             band_offsets[lh], band_offsets[hh], pos, w, h,
                             mh, mv, int(pre)))
                self.last[i] = len(self.jobs)
                self.jobs.append((i, lev, w, h))
                self.out_offsets.append(pos)
                per_level[-1] += 1
                pos += w * h
        self.total = pos
        self.table = np.array(rows, np.int64).reshape(-1, _JOB_INTS)
        self.launches = sum(-(-n // MAX_JOBS) for n in per_level)

    @classmethod
    def of_jobs(cls, dims, transform: int):
        """A one-level plan of jobs given as tensors: its table's inputs
        are element offsets from the first job's LL, filled in per call by
        ``dwt_lift``. `dims` is each job's (w, h, mh, mv, preshift)."""
        plan = cls([], [], [], transform)
        rows, pos = [], 0
        for i, (w, h, mh, mv, pre) in enumerate(dims):
            rows.append((0, 0, 0, 0, 0, 0, pos, w, h, mh, mv, int(pre)))
            plan.jobs.append((i, 0, w, h))
            plan.out_offsets.append(pos)
            pos += w * h
        plan.total = pos
        plan.table = np.array(rows, np.int64).reshape(-1, _JOB_INTS)
        plan.launches = -(-len(dims) // MAX_JOBS)
        return plan

    def view(self, scratch, j: int):
        """Job j's output, an (h, w) view of a call's scratch buffer."""
        _i, _l, w, h = self.jobs[j]
        return scratch.as_strided((h, w), (w, 1), self.out_offsets[j])


def _launch(plan: LiftPlan, base: int, out):
    """Launch the kernel on every job of `plan`: inputs at element offsets
    from the address `base`, outputs into `out`. Adds the launches made
    to ``dwt_lift.launches``."""
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


def dwt_lift_program_ref(plan: LiftPlan, bands):
    """Plain PyTorch version of ``dwt_lift_program``: ``dwt_level_ref``
    job by job, each output copied into the scratch buffer."""
    _check_bands(plan, bands)
    scratch = torch.empty(plan.total, dtype=bands.dtype, device=bands.device)

    def band(buf, off, rows, cols):
        return buf[off:off + rows * cols].view(rows, cols)

    for j, (_lev, ll_out, ll, hl, lh, hh, _o, w, h, mh, mv, pre) in \
            enumerate(plan.table.tolist()):
        nE, nEv = (w + 1 - mh) // 2, (h + 1 - mv) // 2
        plan.view(scratch, j).copy_(dwt_torch.dwt_level_ref(
            band(scratch if ll_out else bands, ll, nEv, nE),
            band(bands, hl, nEv, w - nE), band(bands, lh, h - nEv, nE),
            band(bands, hh, h - nEv, w - nE), mh, mv, plan.transform,
            bool(pre)))
    return scratch


def dwt_lift_program(plan: LiftPlan, bands):
    """Every job of `plan` on the band buffer `bands` (1-D, contiguous,
    int32; float32 for DWT97): returns one scratch buffer that holds
    every job's output (``plan.view(scratch, j)``). A CUDA tensor takes
    one launch a level; a CPU tensor the plain version."""
    _check_bands(plan, bands)
    if bands.device.type == "cpu":
        return dwt_lift_program_ref(plan, bands)
    scratch = torch.empty(plan.total, dtype=bands.dtype, device=bands.device)
    if plan.jobs:
        _launch(plan, bands.data_ptr(), scratch)
    return scratch


def dwt_lift(jobs, transform: int):
    """One inverse DWT level of each job; returns their next LLs, (h, w)
    tensors in job order.

    A job is ``(ll, hl, lh, hh, mh, mv, preshift)``: the previous LL and
    the level's HL, LH and HH (int32; float32 for DWT97), the level's
    origin parities, and whether the integer 9/7's final rounding shift
    follows (its last level). All jobs lie on one device."""
    dtype = _dtype(transform)
    jobs = [tuple(j) for j in jobs]
    if not jobs:
        return []
    dev = jobs[0][0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    dims = [_check_job(j, dtype, dev, transform) for j in jobs]
    if dev.type == "cpu":
        return [dwt_torch.dwt_level_ref(*j[:6], transform, bool(j[6]))
                for j in jobs]
    plan = LiftPlan.of_jobs([(w, h, j[4], j[5], j[6])
                             for (w, h), j in zip(dims, jobs)], transform)
    base = jobs[0][0].data_ptr()
    size = jobs[0][0].element_size()
    plan.table[:, 2:6] = [[(t.data_ptr() - base) // size for t in j[:4]]
                          for j in jobs]
    scratch = torch.empty(plan.total, dtype=dtype, device=dev)
    _launch(plan, base, scratch)
    return [plan.view(scratch, j) for j in range(len(jobs))]


dwt_lift.launches = 0   # kernel launches: one a level of <= 48 jobs
