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

Both can write the clipped planes straight into the narrow output buffer
(``out``), which is how the programs call them: that fuses the frame
write into the same pass. Where each plane goes is its *dest*, ``(dst,
rs, cs, sh)``: sample (r, c) at ``out[dst + r*rs + c*cs]``, shifted left
by ``sh`` (``csrc/frame_store.cuh``). The programs pass the frame layout
of the negotiated pixel format (``models/assembly.FrameLayout``: R, G, B
interleaved with ``cs`` 3 in ``rgb48le``, shifted to 16 bits), or planes
back to back, ``(offset, W, 1, 0)``, the default. ``rct_writeframe``
takes one frame's planes; ``ict_writeframe`` takes the planes of every
frame of a batch and writes them all in one launch. CPU tensors take the
plain versions (``rct_writeframe_ref``, ``ict_writeframe_ref``), which
take the same ``out`` and dests; CUDA tensors launch
``csrc/rct_writeframe.cu`` or ``csrc/ict_writeframe.cu``.

``plane_writeframe`` is the same tail for the planes that no MCT takes
(``finish`` and the packing of the JAX programs, assembly.py:389 and
decoder.py:546): DC shift, clip and the frame write of any number of
planes, each to its own dest in the output, in one launch on
the card (``csrc/plane_writeframe.cu``); the plain version is
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
MAX_PLANES = 120              # planes per plane_writeframe launch
                              # (kMaxPlanes in the .cu)


def dc_shift_clip(c, cbps: int):
    """``finish`` of the JAX program: float samples are rounded half to
    even first; then + (1 << (cbps - 1)) in int32, clipped to
    [0, 2**cbps - 1]."""
    if c.is_floating_point():
        c = torch.round(c).to(torch.int32)
    return torch.clamp(c + (1 << (cbps - 1)), 0, (1 << cbps) - 1)


def rct_writeframe_ref(y0, y1, y2, cbps: int, out=None, dests=None):
    """Plain PyTorch inverse RCT + DC shift + clip: three int32 planes, or,
    with `out`, those planes written into it at `dests` (``store_ref``)
    and `out`."""
    g = y0 - ((y2 + y1) >> 2)
    r = g + y2
    b = g + y1
    return _into(tuple(dc_shift_clip(c, cbps) for c in (r, g, b)), out,
                 dests)


def _qmul(c: int, v):
    """(int32)((uint32)c * (uint32)v + 2^15) >> 16 on CPU-capable dtypes:
    the product in int64 (the signed coefficient equals the unsigned one
    mod 2^32 and keeps the product inside int64), masked to 32 bits and
    reinterpreted as int32 before the arithmetic shift."""
    prod = (c * v.to(torch.int64) + (1 << 15)) & 0xFFFFFFFF
    return ((prod - ((prod & 0x80000000) << 1)) >> 16).to(torch.int32)


def ict_writeframe_ref(y0, y1, y2, cbps: int, transform: int, out=None,
                       dests=None):
    """Plain PyTorch inverse ICT + DC shift + clip: three int32 planes, or,
    with `out`, those planes written into it at `dests` and `out`.

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
    return _into(tuple(dc_shift_clip(c, cbps) for c in (i0, i1, i2)), out,
                 dests)


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


def _check_out(out, device, cbps: int):
    """Raise unless `out` (None: int32 planes) is a contiguous 1-D tensor
    of a packed dtype on `device` that holds cbps-bit samples."""
    dtype = torch.int32 if out is None else out.dtype
    if dtype not in _OUT_KIND:
        raise TypeError(f"out has dtype {dtype}")
    if out is not None and (out.device != device or out.dim() != 1
                            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous 1-D tensor on {device}")
    if not 1 <= cbps <= _MAX_CBPS[dtype]:
        raise ValueError(f"{cbps}-bit samples do not fit {dtype}")


def back_to_back(shape, count: int = 3, first: int = 0):
    """The dests of `count` planes of `shape` back to back from `first`,
    unshifted: the layout of a program's tile-component planes."""
    h, w = shape
    return [(first + k * h * w, w, 1, 0) for k in range(count)]


def _check_dest(dest, shape, size: int, cbps: int, dtype):
    """Raise unless every sample of a `shape` plane at `dest` lies in an
    output of `size` samples and its shifted cbps-bit samples fit
    `dtype`; returns the dest as four ints."""
    dst, rs, cs, sh = (int(v) for v in dest)
    if dst < 0 or rs < 0 or cs < 1 or sh < 0 \
            or cbps + sh > _MAX_CBPS[dtype]:
        raise ValueError(f"dest {dest} does not take {cbps}-bit samples "
                         f"in {dtype}")
    h, w = shape
    if h and w and dst + (h - 1) * rs + (w - 1) * cs >= size:
        raise ValueError(f"a {h}x{w} plane at {dest} overruns out ({size})")
    return dst, rs, cs, sh


def store_ref(c, out, dest):
    """Clipped int32 samples `c` (H, W), shifted left by the dest's shift
    and narrowed, into `out` at `dest` = (dst, rs, cs, sh): sample (r, q)
    at out[dst + r*rs + q*cs]."""
    dst, rs, cs, sh = dest
    view = out.as_strided(tuple(c.shape), (rs, cs),
                          out.storage_offset() + dst)
    view.copy_(narrow(c << sh, out.dtype))


def _into(planes, out, dests):
    """The plain versions' result: the planes, or each written into `out`
    at its dest (default: back to back) and `out`."""
    if out is None:
        return planes
    for c, d in zip(planes, dests or back_to_back(planes[0].shape)):
        store_ref(c, out, d)
    return out


def _dest_table(dests, shape, size: int, cbps: int, dtype, count: int = 3):
    """`count` dests (default: back to back), checked, as a C int64
    array of 4 values each."""
    dests = back_to_back(shape, count) if dests is None else list(dests)
    if len(dests) != count:
        raise ValueError(f"{count} dests, one a plane")
    table = [v for d in dests for v in _check_dest(d, shape, size, cbps,
                                                    dtype)]
    return dests, (ctypes.c_int64 * len(table))(*table)


def rct_writeframe(y0, y1, y2, cbps: int, out=None, dests=None):
    """(Y, Cb, Cr) int32 (H, W) planes -> clipped (R, G, B).

    Without `out`, returns three int32 (H, W) planes. With `out`, a
    contiguous 1-D tensor (int32, int16 holding uint16 bits, or uint8),
    writes R, G, B into it, each at its dest of `dests` (default: back to
    back from out[0]), and returns it.
    """
    n = _check_planes(y0, y1, y2, torch.int32, y0.shape, y0.device)
    _check_out(out, y0.device, cbps)
    if out is None and dests is not None:
        raise ValueError("dests need an out")
    ret = out
    if out is None:
        out = torch.empty((3 * n,), dtype=torch.int32, device=y0.device)
    dests, table = _dest_table(dests, tuple(y0.shape), out.numel(), cbps,
                               out.dtype)
    if y0.device.type == "cpu":
        rct_writeframe_ref(y0, y1, y2, cbps, out, dests)
    else:
        with torch.cuda.device(y0.device):
            err = build.load().lib.rct_writeframe_launch(
                y0.data_ptr(), y1.data_ptr(), y2.data_ptr(), *y0.shape,
                cbps, out.data_ptr(), out.numel(), _OUT_KIND[out.dtype],
                table, torch.cuda.current_stream(y0.device).cuda_stream)
        build.check(err, "rct_writeframe_launch")
        rct_writeframe.launches += 1
    if ret is None:
        return tuple(out.view(3, *y0.shape))
    return out


rct_writeframe.launches = 0   # CUDA kernel launches


def ict_writeframe(frames, cbps: int, transform: int, out=None,
                   frame_stride=None, dests=None):
    """Inverse ICT of F frames' (H, W) planes -> clipped samples, in one
    launch on the card (one per 32 frames).

    `frames` is a sequence of F (y0, y1, y2) triples of one shape, dtype
    and device; `transform` is DWT97_INT (int32 planes, integer ICT) or
    DWT97 (float32 planes, float ICT + rint). Without `out`, returns F
    triples of int32 (H, W) planes. With `out`, a contiguous 1-D tensor
    (int32, int16 holding uint16 bits, or uint8), frame 0's three planes
    are written at `dests` (default: back to back from out[0]), frame f's
    `frame_stride` samples (default 3*H*W) after frame f-1's, and `out` is
    returned."""
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
    if stride < 0:
        raise ValueError(f"frame_stride {stride} < 0")
    _check_out(out, y0.device, cbps)
    if out is None and dests is not None:
        raise ValueError("dests need an out")
    ret = out
    if out is None:
        out = torch.empty((F * 3 * n,), dtype=torch.int32, device=y0.device)
    # the last frame's dests, checked against out, bound every frame's
    size = out.numel() - (F - 1) * stride
    dests, table = _dest_table(dests, tuple(y0.shape), size, cbps,
                               out.dtype)
    if y0.device.type == "cpu":
        for f, planes in enumerate(frames):
            ict_writeframe_ref(*planes, cbps, transform, out,
                               [(d[0] + f * stride, *d[1:]) for d in dests])
    else:
        ptrs = [(ctypes.c_void_p * F)(*(p[c].data_ptr() for p in frames))
                for c in range(3)]
        with torch.cuda.device(y0.device):
            err = build.load().lib.ict_writeframe_launch(
                *ptrs, F, *y0.shape, cbps, out.data_ptr(), out.numel(),
                stride, table, _OUT_KIND[out.dtype], mode,
                torch.cuda.current_stream(y0.device).cuda_stream)
        build.check(err, "ict_writeframe_launch")
        ict_writeframe.launches += -(-F // _ICT_MAX_FRAMES)
    if ret is None:
        return [tuple(out.view(F, 3, *y0.shape)[f]) for f in range(F)]
    return out


ict_writeframe.launches = 0   # CUDA kernel launches


def _shape2(p):
    """A plane's (rows, columns); a 1-D plane is one row."""
    return tuple(p.shape) if p.dim() == 2 else (1, p.numel())


def _writes_dests(planes, dests, out, cbps: int):
    """Raise unless `planes` are contiguous int32 (or float32) tensors of
    one dtype on one CPU or CUDA device and each fits `out` at its dest;
    returns their dtype, device and dests as four ints each."""
    if len(planes) != len(dests):
        raise ValueError("one dest a plane")
    dev = out.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    _check_out(out, dev, cbps)
    dtype = planes[0].dtype if planes else torch.int32
    if dtype not in (torch.int32, torch.float32):
        raise TypeError(f"planes have dtype {dtype}")
    checked = []
    for p, d in zip(planes, dests):
        if p.device != dev:
            raise ValueError(f"a plane on {p.device}, expected {dev}")
        if p.dtype != dtype:
            raise TypeError(f"a plane has dtype {p.dtype}, expected {dtype}")
        if not p.is_contiguous():
            raise ValueError("a plane is not contiguous")
        checked.append(_check_dest(d, _shape2(p), out.numel(), cbps,
                                   out.dtype))
    return dtype, dev, checked


def plane_writeframe_ref(planes, cbps: int, out, dests):
    """Plain PyTorch version of ``plane_writeframe``: ``dc_shift_clip``
    and ``store_ref`` a plane at a time."""
    for p, d in zip(planes, dests):
        store_ref(dc_shift_clip(p, cbps).reshape(_shape2(p)), out, d)
    return out


def plane_writeframe(planes, cbps: int, out, dests):
    """DC shift + clip (float samples rounded half to even first) of each
    of `planes` (contiguous int32 or float32 tensors of one dtype), each
    narrowed into `out` (a contiguous 1-D int32, int16 holding uint16
    bits, or uint8 tensor) at its dest (dst, rs, cs, sh) of `dests`
    (``back_to_back(shape, 1, offset)`` puts a plane's samples in a row
    from an offset); returns `out`. A CUDA tensor takes one launch for
    every MAX_PLANES planes; a CPU tensor the plain version."""
    planes, dests = list(planes), list(dests)
    dtype, dev, dests = _writes_dests(planes, dests, out, cbps)
    if dev.type == "cpu":
        return plane_writeframe_ref(planes, cbps, out, dests)
    live = [(p, d) for p, d in zip(planes, dests) if p.numel()]
    if not live:
        return out
    base = live[0][0].data_ptr()
    table = np.array([((p.data_ptr() - base) // 4, *_shape2(p), *d)
                      for p, d in live], np.int64)
    n = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = build.load().lib.plane_writeframe_launch(
            table.ctypes.data, len(table), base, int(dtype == torch.float32),
            cbps, out.data_ptr(), out.numel(), _OUT_KIND[out.dtype],
            torch.cuda.current_stream(dev).cuda_stream, ctypes.addressof(n))
    build.check(err, "plane_writeframe_launch")
    plane_writeframe.launches += n.value
    return out


def plane_writeframe_launches(nplanes: int) -> int:
    """The launches ``plane_writeframe`` makes for `nplanes` planes with
    samples: one each MAX_PLANES."""
    return -(-nplanes // MAX_PLANES)


plane_writeframe.launches = 0   # CUDA kernel launches
