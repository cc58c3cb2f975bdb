"""Inverse RCT / ICT + DC shift + clip (+ narrow pack) for frames with MCT.

``rct_writeframe`` (5/3 frames) has the contract of
``ffmpeg_ht_tpu.ops.mct_pallas.rct_writeframe``: (Y, Cb, Cr) int32 (H, W)
planes -> clipped (R, G, B) int32 planes, with

    g = y0 - ((y2 + y1) >> 2),  r = g + y2,  b = g + y1   (wraparound int32)

then ``+ (1 << (cbps - 1))`` and a clip to ``[0, 2**cbps - 1]``
(jpeg2000dsp.c:78-91, write_frame jpeg2000dec.c:2301-2364).

``ict_writeframe`` (9/7 frames) is the tail of the JAX package's v3
program for the irreversible transforms (``ffmpeg_ht_tpu.models.assembly``
``ict_int`` / ``ict_float`` and ``finish``, assembly.py:390-408): the
integer ICT with u32-wraparound Q16 products on int32 planes, or the
float ICT on float32 planes followed by ``rint`` (half to even); then the
same DC shift and clip.

Both can write the clipped planes straight into the packed narrow output
buffer (``out``), which is how the v3 program calls them: that fuses the
pack into the same pass. ``rct_writeframe`` takes one frame's planes;
``ict_writeframe`` takes the planes of every frame of a batch and writes
them all in one launch. CPU tensors take the plain versions
(``rct_writeframe_ref``, ``ict_writeframe_ref``) followed by the
narrowing copy; CUDA tensors launch ``csrc/rct_writeframe.cu`` or
``csrc/ict_writeframe.cu``.

``plane_writeframe`` is the same tail for the planes that no MCT takes
(``finish`` and the packing of the JAX programs, assembly.py:389 and
decoder.py:546): DC shift, clip and narrow pack of any number of planes,
each to its own offset in the packed output, in one launch on the card
(``csrc/plane_writeframe.cu``); the plain version is
``plane_writeframe_ref``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ffmpeg_ht_tpu_torch.ops.dwt import DWT97, DWT97_INT
from ffmpeg_ht_tpu_torch.ops.mct import F_ICT
from ffmpeg_ht_tpu_torch.utils import build
from ffmpeg_ht_tpu_torch.utils.device import check_tensor

# packed output dtypes: torch has no complete uint16, so 16-bit samples are
# held as int16 bit patterns (read back with numpy .view(np.uint16))
_OUT_KIND = {torch.int32: 0, torch.int16: 1, torch.uint8: 2}
_MAX_CBPS = {torch.int32: 30, torch.int16: 16, torch.uint8: 8}
# ict_writeframe_launch modes, and the plane dtype each takes
_ICT_MODE = {DWT97_INT: (0, torch.int32), DWT97: (1, torch.float32)}
_F0, _F1, _F2, _F3 = (float(v) for v in F_ICT)   # exact float32 values
_ICT_MAX_FRAMES = 32          # frames per launch (kMaxFrames in the .cu)
MAX_PLANES = 160              # planes per plane_writeframe launch
                              # (kMaxPlanes in the .cu)


def dc_shift_clip(c, cbps: int):
    """``finish`` of the JAX program: float samples are rounded half to
    even first; then + (1 << (cbps - 1)) in int32, clipped to
    [0, 2**cbps - 1]."""
    if c.is_floating_point():
        c = torch.round(c).to(torch.int32)
    return torch.clamp(c + (1 << (cbps - 1)), 0, (1 << cbps) - 1)


def rct_writeframe_ref(y0, y1, y2, cbps: int):
    """Plain PyTorch inverse RCT + DC shift + clip: three int32 planes."""
    g = y0 - ((y2 + y1) >> 2)
    r = g + y2
    b = g + y1
    return tuple(dc_shift_clip(c, cbps) for c in (r, g, b))


def _qmul(c: int, v):
    """(int32)((uint32)c * (uint32)v + 2^15) >> 16 on CPU-capable dtypes:
    the product in int64 (the signed coefficient equals the unsigned one
    mod 2^32 and keeps the product inside int64), masked to 32 bits and
    reinterpreted as int32 before the arithmetic shift."""
    prod = (c * v.to(torch.int64) + (1 << 15)) & 0xFFFFFFFF
    return ((prod - ((prod & 0x80000000) << 1)) >> 16).to(torch.int32)


def ict_writeframe_ref(y0, y1, y2, cbps: int, transform: int):
    """Plain PyTorch inverse ICT + DC shift + clip: three int32 planes.

    DWT97_INT: int32 planes, wraparound int32 (``ict_int``); DWT97:
    float32 planes, every operation rounded to float32 in the order
    ``(y0 - f1*y1) - f2*y2`` (``ict_float``), then ``rint``."""
    if transform == DWT97_INT:
        i0 = y0 + y2 + _qmul(26345, y2)
        i1 = y0 - _qmul(22553, y1) - _qmul(46802, y2)
        i2 = y0 + 2 * y1 + _qmul(-14942, y1)
    elif transform == DWT97:
        i0 = y0 + _F0 * y2
        i1 = y0 - _F1 * y1 - _F2 * y2
        i2 = y0 + _F3 * y1
    else:
        raise ValueError(f"ICT needs a 9/7 transform, got {transform}")
    return tuple(dc_shift_clip(c, cbps) for c in (i0, i1, i2))


def narrow(c, dtype):
    """Clipped int32 samples -> the packed buffer's dtype, wrapping like
    numpy's astype (uint16 values become int16 bit patterns)."""
    if dtype == torch.int16:
        return ((c & 0xFFFF) - ((c & 0x8000) << 1)).to(torch.int16)
    if dtype == torch.uint8:
        return (c & 0xFF).to(torch.uint8)
    return c.to(dtype)


def _check_planes(y0, y1, y2, dtype, shape, device):
    """Raise unless y0, y1, y2 are contiguous `dtype` planes of `shape` on
    a CPU or CUDA `device`; returns their sample count."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    for name, t in (("y0", y0), ("y1", y1), ("y2", y2)):
        check_tensor(t, name, dtype, device, 2, shape[0])
        if t.shape != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}")
    return y0.numel()


def _check_out(out, numel: int, device, cbps: int):
    """Raise unless `out` (None: int32 planes) is a contiguous 1-D tensor
    of `numel` samples of a packed dtype on `device` that holds cbps-bit
    samples."""
    dtype = torch.int32 if out is None else out.dtype
    if dtype not in _OUT_KIND:
        raise TypeError(f"out has dtype {dtype}")
    if out is not None and (out.device != device or out.dim() != 1
                            or out.numel() != numel
                            or not out.is_contiguous()):
        raise ValueError("out must be a contiguous 1-D tensor of "
                         f"{numel} elements on {device}")
    if not 1 <= cbps <= _MAX_CBPS[dtype]:
        raise ValueError(f"{cbps}-bit samples do not fit {dtype}")


def _plain_into(planes, out):
    """The plain version's result, as planes or narrowed into `out`."""
    if out is None:
        return planes
    n = planes[0].numel()
    for i, c in enumerate(planes):
        out[i * n:(i + 1) * n] = narrow(c, out.dtype).reshape(-1)
    return out


def rct_writeframe(y0, y1, y2, cbps: int, out=None):
    """(Y, Cb, Cr) int32 (H, W) planes -> clipped (R, G, B).

    Without `out`, returns three int32 (H, W) planes. With `out`, a
    contiguous 1-D tensor of 3*H*W elements (int32, int16 holding uint16
    bits, or uint8), writes R, G, B back to back into it and returns it.
    """
    n = _check_planes(y0, y1, y2, torch.int32, y0.shape, y0.device)
    _check_out(out, 3 * n, y0.device, cbps)
    if y0.device.type == "cpu":
        return _plain_into(rct_writeframe_ref(y0, y1, y2, cbps), out)
    ret = out
    if out is None:
        out = torch.empty((3 * n,), dtype=torch.int32, device=y0.device)
    with torch.cuda.device(y0.device):
        err = build.load().lib.rct_writeframe_launch(
            y0.data_ptr(), y1.data_ptr(), y2.data_ptr(), n, cbps,
            out.data_ptr(), _OUT_KIND[out.dtype],
            torch.cuda.current_stream(y0.device).cuda_stream)
    build.check(err, "rct_writeframe_launch")
    rct_writeframe.launches += 1
    if ret is None:
        return tuple(out.view(3, *y0.shape))
    return out


rct_writeframe.launches = 0   # CUDA kernel launches


def ict_writeframe(frames, cbps: int, transform: int, out=None,
                   frame_stride=None):
    """Inverse ICT of F frames' (H, W) planes -> clipped samples, in one
    launch on the card (one per 32 frames).

    `frames` is a sequence of F (y0, y1, y2) triples of one shape, dtype
    and device; `transform` is DWT97_INT (int32 planes, integer ICT) or
    DWT97 (float32 planes, float ICT + rint). Without `out`, returns F
    triples of int32 (H, W) planes. With `out`, a contiguous 1-D tensor
    (int32, int16 holding uint16 bits, or uint8), frame f's three planes
    are written back to back from out[f * frame_stride] (frame_stride
    defaults to 3*H*W; out holds (F-1) * frame_stride + 3*H*W samples),
    and `out` is returned."""
    if transform not in _ICT_MODE:
        raise ValueError(f"ICT needs a 9/7 transform, got {transform}")
    mode, dtype = _ICT_MODE[transform]
    frames = [tuple(f) for f in frames]
    if not frames or any(len(f) != 3 for f in frames):
        raise ValueError("frames must be one or more (y0, y1, y2) triples")
    y0 = frames[0][0]
    for planes in frames:
        n = _check_planes(*planes, dtype, y0.shape, y0.device)
    F = len(frames)
    stride = 3 * n if frame_stride is None else frame_stride
    if stride < 3 * n:
        raise ValueError(f"frame_stride {stride} < 3*{n}")
    _check_out(out, (F - 1) * stride + 3 * n, y0.device, cbps)
    ret = out
    if out is None:
        out = torch.empty((F * 3 * n,), dtype=torch.int32, device=y0.device)
    if y0.device.type == "cpu":
        for f, planes in enumerate(frames):
            _plain_into(ict_writeframe_ref(*planes, cbps, transform),
                        out[f * stride:f * stride + 3 * n])
    else:
        ptrs = [(ctypes.c_void_p * F)(*(p[c].data_ptr() for p in frames))
                for c in range(3)]
        with torch.cuda.device(y0.device):
            err = build.load().lib.ict_writeframe_launch(
                *ptrs, F, n, cbps, out.data_ptr(), stride,
                _OUT_KIND[out.dtype], mode,
                torch.cuda.current_stream(y0.device).cuda_stream)
        build.check(err, "ict_writeframe_launch")
        ict_writeframe.launches += -(-F // _ICT_MAX_FRAMES)
    if ret is None:
        return [tuple(out.view(F, 3, *y0.shape)[f]) for f in range(F)]
    return out


ict_writeframe.launches = 0   # CUDA kernel launches


def _check_writes(planes, offsets, out, cbps: int):
    """Raise unless `planes` are contiguous int32 (or float32) tensors of
    one dtype on one CPU or CUDA device and each fits `out` at its
    offset; returns their dtype and device."""
    if len(planes) != len(offsets):
        raise ValueError("one offset a plane")
    dev = out.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    _check_out(out, out.numel(), dev, cbps)
    dtype = planes[0].dtype if planes else torch.int32
    if dtype not in (torch.int32, torch.float32):
        raise TypeError(f"planes have dtype {dtype}")
    for p, o in zip(planes, offsets):
        if p.device != dev:
            raise ValueError(f"a plane on {p.device}, expected {dev}")
        if p.dtype != dtype:
            raise TypeError(f"a plane has dtype {p.dtype}, expected {dtype}")
        if not p.is_contiguous():
            raise ValueError("a plane is not contiguous")
        if o < 0 or o + p.numel() > out.numel():
            raise ValueError(f"a plane of {p.numel()} samples at {o} "
                             f"overruns out ({out.numel()})")
    return dtype, dev


def plane_writeframe_ref(planes, cbps: int, out, offsets):
    """Plain PyTorch version of ``plane_writeframe``: ``dc_shift_clip``
    and ``narrow`` a plane at a time."""
    for p, o in zip(planes, offsets):
        out[o:o + p.numel()] = narrow(dc_shift_clip(p, cbps),
                                      out.dtype).reshape(-1)
    return out


def plane_writeframe(planes, cbps: int, out, offsets):
    """DC shift + clip (float samples rounded half to even first) of each
    of `planes` (contiguous int32 or float32 tensors of one dtype), each
    narrowed into `out` (a contiguous 1-D int32, int16 holding uint16
    bits, or uint8 tensor) from its offset in `offsets`; returns `out`.
    A CUDA tensor takes one launch for every MAX_PLANES planes; a CPU
    tensor the plain version."""
    planes, offsets = list(planes), [int(o) for o in offsets]
    dtype, dev = _check_writes(planes, offsets, out, cbps)
    if dev.type == "cpu":
        return plane_writeframe_ref(planes, cbps, out, offsets)
    live = [(p, o) for p, o in zip(planes, offsets) if p.numel()]
    if not live:
        return out
    base = live[0][0].data_ptr()
    table = np.array([((p.data_ptr() - base) // 4, p.numel(), o)
                      for p, o in live], np.int64)
    n = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = build.load().lib.plane_writeframe_launch(
            table.ctypes.data, len(table), base, int(dtype == torch.float32),
            cbps, out.data_ptr(), _OUT_KIND[out.dtype],
            torch.cuda.current_stream(dev).cuda_stream, ctypes.addressof(n))
    build.check(err, "plane_writeframe_launch")
    plane_writeframe.launches += n.value
    return out


def plane_writeframe_launches(nplanes: int) -> int:
    """The launches ``plane_writeframe`` makes for `nplanes` planes with
    samples: one each MAX_PLANES."""
    return -(-nplanes // MAX_PLANES)


plane_writeframe.launches = 0   # CUDA kernel launches
