"""One band-direct inverse DWT level of several planes on the card.

``dwt_lift`` runs one level of ``dwt_torch.dwt_decode_bands`` (5/3,
integer 9/7, float 9/7; the JAX package's ``dwt_jax.dwt_decode_bands``)
for every plane of every frame of a ``V3Program`` at once: a job is one
plane's previous LL and the level's HL, LH and HH, and its result the
plane's next LL. CUDA tensors launch ``csrc/dwt_lift.cu`` (a row launch
and a column launch per 32 jobs); CPU tensors take the plain version,
``dwt_torch.dwt_level_ref``, job by job. Levels below 8x8 belong to the
flat fallback (``dwt_torch.dwt_decode_flat``) and raise on either device.
"""

from __future__ import annotations

import ctypes

import torch

from ffmpeg_ht_tpu_torch.ops import dwt_torch
from ffmpeg_ht_tpu_torch.ops.dwt import DWT53, DWT97, DWT97_INT
from ffmpeg_ht_tpu_torch.utils import build

# dwt_lift_launch modes
_MODE = {DWT53: 0, DWT97_INT: 1, DWT97: 2}
_MAX_JOBS = 32                # jobs per launch pair (kMaxJobs in the .cu)


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
    w, h = ll.shape[1] + hl.shape[1], ll.shape[0] + lh.shape[0]
    if mh not in (0, 1) or mv not in (0, 1) \
            or hl.shape[0] != ll.shape[0] or lh.shape[1] != ll.shape[1] \
            or tuple(hh.shape) != (lh.shape[0], hl.shape[1]) \
            or ll.shape[1] != (w + 1 - mh) // 2 \
            or ll.shape[0] != (h + 1 - mv) // 2:
        raise ValueError(f"bands {tuple(ll.shape)}, {tuple(hl.shape)}, "
                         f"{tuple(lh.shape)}, {tuple(hh.shape)} do not "
                         f"split a level at parities ({mh}, {mv})")
    if w < 8 or h < 8:
        raise ValueError(f"a {w}x{h} level is below 8x8: use "
                         "dwt_decode_flat")
    if pre and transform != DWT97_INT:
        raise ValueError("preshift belongs to the integer 9/7")
    return w, h


def dwt_lift(jobs, transform: int):
    """One inverse DWT level of each job; returns their next LLs, (h, w)
    tensors in job order.

    A job is ``(ll, hl, lh, hh, mh, mv, preshift)``: the previous LL and
    the level's HL, LH and HH (int32; float32 for DWT97), the level's
    origin parities, and whether the integer 9/7's final rounding shift
    follows (its last level). All jobs lie on one device."""
    if transform not in _MODE:
        raise ValueError(f"unknown transform {transform}")
    jobs = [tuple(j) for j in jobs]
    if not jobs:
        return []
    dev = jobs[0][0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    dtype = torch.float32 if transform == DWT97 else torch.int32
    dims = [_check_job(j, dtype, dev, transform) for j in jobs]
    if dev.type == "cpu":
        return [dwt_torch.dwt_level_ref(*j[:6], transform, bool(j[6]))
                for j in jobs]
    buf = torch.empty(sum(w * h for w, h in dims), dtype=dtype, device=dev)
    outs, pos = [], 0
    for w, h in dims:
        outs.append(buf[pos:pos + w * h].view(h, w))
        pos += w * h
    n = len(jobs)
    ptrs = [(ctypes.c_void_p * n)(*(j[i].data_ptr() for j in jobs))
            for i in range(4)]
    out_ptrs = (ctypes.c_void_p * n)(*(o.data_ptr() for o in outs))
    ints = (ctypes.c_int * (5 * n))(*(
        v for (w, h), j in zip(dims, jobs)
        for v in (w, h, j[4], j[5], int(bool(j[6])))))
    with torch.cuda.device(dev):
        err = build.load().lib.dwt_lift_launch(
            *ptrs, out_ptrs, ints, n, _MODE[transform],
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "dwt_lift_launch")
    dwt_lift.launches += -(-n // _MAX_JOBS)
    return outs


dwt_lift.launches = 0   # row + column launch pairs
