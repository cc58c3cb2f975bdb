"""Output pixel-format conversion — the swscale analog (SURVEY.md §1 L4).

The reference routes decoder output through libswscale when the caller
asks for a different pixel format (FATE's jpeg2000 tests pass
`-pix_fmt rgb48le` etc., tests/fate/jpeg2000.mak:37-41). This module
supplies the same surface for our decoder: `convert(frame, dst_fmt)`
returns a new DecodedFrame in the requested format.

Exactness tiers (each pinned against the reference binary under
`-flags +bitexact` in tests/test_swscale.py):

- **Byte-exact**: every same-colorspace bit-depth change. These
  replicate libswscale's planar copy semantics
  (libswscale/swscale_unscaled.c:2076-2265, planarCopyWrapper):
  upshifts are MSB replication `(v << k) | (v >> (2*src-dst))` for
  full-range planes (gray/RGB) and a plain `v << k` for limited-range
  (YUV) planes; downshifts apply the 8x8 ordered-dither matrices
  (DITHER_COPY) — full-range `(v - (v >> dst) + D) >> k`,
  limited-range `t = (v + D) >> k; t - (t >> dst)`. yuv->yuv depth
  changes run plane-direct (never through an RGB intermediate).
  The FATE conversion pattern (`-pix_fmt rgb48le`,
  tests/fate/jpeg2000.mak:37-41) is also exact: >8-bit RGB decodes
  natively to MSB-aligned rgb48, so that "conversion" is an identity.
- **±1 LSB**: colorspace transforms. gray <-> RGB by replication /
  BT.601 luma; YCbCr <-> RGB by the BT.601 limited-range integer
  matrix; chroma box-down / sample-and-hold up. libswscale routes
  these through its 15/19-bit YUV intermediate pipeline whose exact
  output depends on per-format converter selection; replicating that
  maze is out of scope by design — tests pin these within ±1 LSB.
"""

from __future__ import annotations

import numpy as np

from ffmpeg_ht_tpu_torch.models import pixfmt as pf
from ffmpeg_ht_tpu_torch.models.host_decoder import DecodedFrame

# libswscale's ordered-dither matrices for depth reduction, indexed by
# (shift - 1); unavoidable table constants from
# libswscale/swscale_unscaled.c:38-112 (`dithers[8][8][8]`).
_DITHERS = np.array([
    [[0, 1, 0, 1, 0, 1, 0, 1], [1, 0, 1, 0, 1, 0, 1, 0]] * 4,
    [[1, 2, 1, 2, 1, 2, 1, 2], [3, 0, 3, 0, 3, 0, 3, 0]] * 4,
    [[2, 4, 3, 5, 2, 4, 3, 5], [6, 0, 7, 1, 6, 0, 7, 1],
     [3, 5, 2, 4, 3, 5, 2, 4], [7, 1, 6, 0, 7, 1, 6, 0]] * 2,
    [[4, 8, 7, 11, 4, 8, 7, 11], [12, 0, 15, 3, 12, 0, 15, 3],
     [6, 10, 5, 9, 6, 10, 5, 9], [14, 2, 13, 1, 14, 2, 13, 1]] * 2,
    [[9, 17, 15, 23, 8, 16, 14, 22], [25, 1, 31, 7, 24, 0, 30, 6],
     [13, 21, 11, 19, 12, 20, 10, 18], [29, 5, 27, 3, 28, 4, 26, 2],
     [8, 16, 14, 22, 9, 17, 15, 23], [24, 0, 30, 6, 25, 1, 31, 7],
     [12, 20, 10, 18, 13, 21, 11, 19], [28, 4, 26, 2, 29, 5, 27, 3]],
    [[18, 34, 30, 46, 17, 33, 29, 45], [50, 2, 62, 14, 49, 1, 61, 13],
     [26, 42, 22, 38, 25, 41, 21, 37], [58, 10, 54, 6, 57, 9, 53, 5],
     [16, 32, 28, 44, 19, 35, 31, 47], [48, 0, 60, 12, 51, 3, 63, 15],
     [24, 40, 20, 36, 27, 43, 23, 39], [56, 8, 52, 4, 59, 11, 55, 7]],
    [[18, 34, 30, 46, 17, 33, 29, 45], [50, 2, 62, 14, 49, 1, 61, 13],
     [26, 42, 22, 38, 25, 41, 21, 37], [58, 10, 54, 6, 57, 9, 53, 5],
     [16, 32, 28, 44, 19, 35, 31, 47], [48, 0, 60, 12, 51, 3, 63, 15],
     [24, 40, 20, 36, 27, 43, 23, 39], [56, 8, 52, 4, 59, 11, 55, 7]],
    [[36, 68, 60, 92, 34, 66, 58, 90], [100, 4, 124, 28, 98, 2, 122, 26],
     [52, 84, 44, 76, 50, 82, 42, 74], [116, 20, 108, 12, 114, 18, 106, 10],
     [32, 64, 56, 88, 38, 70, 62, 94], [96, 0, 120, 24, 102, 6, 126, 30],
     [48, 80, 40, 72, 54, 86, 46, 78], [112, 16, 104, 8, 118, 22, 110, 14]],
], dtype=np.uint32)


def _dither_for(shape, shift: int) -> np.ndarray:
    """The 8x8 ordered-dither matrix for a depth reduction by `shift`
    bits, tiled to `shape` (indexed by the plane's own row/col & 7)."""
    d = _DITHERS[shift - 1]
    h, w = shape
    return np.tile(d, (-(-h // 8), -(-w // 8)))[:h, :w]


def _rescale(a: np.ndarray, src_bits: int, dst_bits: int,
             limited: bool = False) -> np.ndarray:
    """Depth change with libswscale's exact planar-copy semantics.

    `limited` selects the limited-range (YUV) variant; gray/RGB planes
    are full-range (libswscale forces jpeg range for gray/RGB sources,
    flipping DITHER_COPY's `shiftonly` off for the luma plane).
    """
    if src_bits == dst_bits:
        return a
    v = a.astype(np.uint32)
    if dst_bits > src_bits:                      # COPY_UP / COPY816
        k = dst_bits - src_bits
        if limited:
            return v << k
        out = v << k
        pos = k - src_bits                       # MSB replication chain
        while pos > -src_bits:
            out |= (v << pos) if pos >= 0 else (v >> -pos)
            pos -= src_bits
        return out
    k = src_bits - dst_bits                      # DITHER_COPY
    d = _dither_for(a.shape, k)
    if limited:
        t = (v + d) >> k
        return t - (t >> dst_bits)
    return (v - (v >> dst_bits) + d) >> k


_BY_NAME = {f.name: f for f in pf.ALL_FMTS}


def _fmt(name: str):
    f = _BY_NAME.get(name)
    if f is None:
        raise ValueError(f"unknown pixel format {name!r}")
    return f


def _to_planes16(frame: DecodedFrame):
    """Normalize any frame to a list of full-res uint16 planes plus
    (depth, kind): kind 'gray' | 'rgb' | 'yuv' with chroma log2 shifts."""
    f = frame.fmt
    name = f.name
    if name.startswith("gray"):
        return [frame.planes[0]], ("gray", (0, 0))
    if name.startswith("ya"):
        # gray + alpha, interleaved: convert from the gray plane, drop
        # alpha (sws converts out of ya* by compositing/dropping; we drop)
        return [frame.planes[0][:, 0::2]], ("gray", (0, 0))
    if name.startswith("rgb"):
        if f.planar:
            return list(frame.planes[:3]), ("rgb", (0, 0))
        il = frame.planes[0]
        return ([il[:, 0::3], il[:, 1::3], il[:, 2::3]],
                ("rgb", (0, 0)))
    if name.startswith("yuv"):
        return (list(frame.planes[:3]),
                ("yuv", (f.log2_chroma_w, f.log2_chroma_h)))
    raise ValueError(f"unsupported source format {name!r}")


def _box_down(p: np.ndarray, sx: int, sy: int) -> np.ndarray:
    if sx == 0 and sy == 0:
        return p
    h, w = p.shape
    fy, fx = 1 << sy, 1 << sx
    hp, wp = -(-h // fy) * fy, -(-w // fx) * fx
    if (hp, wp) != (h, w):                      # replicate-pad odd edges
        pad = np.pad(p, ((0, hp - h), (0, wp - w)), mode="edge")
    else:
        pad = p
    v = pad.reshape(hp // fy, fy, wp // fx, fx).astype(np.int64)
    return (v.sum(axis=(1, 3)) + (fy * fx) // 2) // (fy * fx)


def _hold_up(p: np.ndarray, sx: int, sy: int, h: int, w: int) -> np.ndarray:
    out = np.repeat(np.repeat(p, 1 << sy, axis=0), 1 << sx, axis=1)
    return out[:h, :w]


# BT.601 limited-range, 16-bit fixed point (the swscale defaults for
# untagged content; coefficients from the Rec. 601 matrix scaled to the
# 219/224-step ranges)
def _yuv_to_rgb(y, u, v, bits):
    ymax = (1 << bits) - 1
    sc = 1 << (bits - 8)
    y = y.astype(np.int64) - 16 * sc
    u = u.astype(np.int64) - 128 * sc
    v = v.astype(np.int64) - 128 * sc
    # 65536 * 255/219 etc.
    cy, crv, cgu, cgv, cbu = 76309, 104597, 25675, 53279, 132201
    r = (cy * y + crv * v + 32768) >> 16
    g = (cy * y - cgu * u - cgv * v + 32768) >> 16
    b = (cy * y + cbu * u + 32768) >> 16
    return tuple(np.clip(c, 0, ymax) for c in (r, g, b))


def _rgb_to_yuv(r, g, b, bits):
    sc = 1 << (bits - 8)
    r = r.astype(np.int64)
    g = g.astype(np.int64)
    b = b.astype(np.int64)
    y = ((16829 * r + 33039 * g + 6416 * b + 32768) >> 16) + 16 * sc
    u = ((-9714 * r - 19071 * g + 28784 * b + 32768) >> 16) + 128 * sc
    v = ((28784 * r - 24103 * g - 4681 * b + 32768) >> 16) + 128 * sc
    mx = (1 << bits) - 1
    return tuple(np.clip(c, 0, mx) for c in (y, u, v))


def convert(frame: DecodedFrame, dst_name: str) -> DecodedFrame:
    """Convert a decoded frame to `dst_name` (pixfmt.FORMATS key)."""
    src = frame.fmt
    if dst_name == src.name:
        return frame
    dst = _fmt(dst_name)
    h, w = frame.height, frame.width
    planes, (kind, shifts) = _to_planes16(frame)
    sbits = src.depths[0]
    dbits = dst.depths[0]

    # yuv -> yuv stays plane-direct (libswscale's planarCopyWrapper,
    # limited-range semantics) — never through an RGB intermediate.
    if kind == "yuv" and dst.name.startswith("yuv"):
        dsh = (dst.log2_chroma_w, dst.log2_chroma_h)
        y, u, v = planes[0], planes[1], planes[2]
        if dsh != shifts:                       # chroma resample first
            u = _hold_up(u, shifts[0], shifts[1], h, w)
            v = _hold_up(v, shifts[0], shifts[1], h, w)
            u = _box_down(u, dsh[0], dsh[1])
            v = _box_down(v, dsh[0], dsh[1])
        out = [_rescale(p, sbits, dbits, limited=True) for p in (y, u, v)]
        dt = np.uint8 if dbits <= 8 else np.uint16
        return DecodedFrame(fmt=dst, width=w, height=h,
                            planes=[p.astype(dt) for p in out])

    # 1) source to full-res RGB-or-gray working set at source depth
    if kind == "yuv":
        u = _hold_up(planes[1], shifts[0], shifts[1], h, w)
        v = _hold_up(planes[2], shifts[0], shifts[1], h, w)
        work = _yuv_to_rgb(planes[0], u, v, sbits)
        kind = "rgb"
    elif kind == "gray":
        work = (planes[0],)
    else:
        work = tuple(planes)

    dname = dst.name

    def rs(p, limited=False):
        return _rescale(p, sbits, dbits, limited=limited)

    if dname.startswith("gray"):
        if len(work) == 3:
            # full-range luma for gray output (sws gray = full-swing Y)
            r, g, b = (p.astype(np.int64) for p in work)
            gray = (19595 * r + 38470 * g + 7471 * b + 32768) >> 16
            gray = np.clip(gray, 0, (1 << sbits) - 1)
        else:
            gray = work[0]
        out = [rs(gray)]
    elif dname.startswith("rgb"):
        rgb = work if len(work) == 3 else (work[0],) * 3
        rgb = [rs(p) for p in rgb]
        if dst.planar:
            out = rgb
        else:
            il = np.zeros((h, 3 * w), np.int64)
            for i, p in enumerate(rgb):
                il[:, i::3] = p
            out = [il]
    elif dname.startswith("yuv"):
        shifts = (dst.log2_chroma_w, dst.log2_chroma_h)
        rgb = work if len(work) == 3 else (work[0],) * 3
        y, u, v = _rgb_to_yuv(*rgb, sbits)
        out = [rs(y, limited=True),
               rs(_box_down(u, shifts[0], shifts[1]), limited=True),
               rs(_box_down(v, shifts[0], shifts[1]), limited=True)]
    else:
        raise ValueError(f"unsupported destination format {dname!r}")

    dt = np.uint8 if dbits <= 8 else np.uint16
    return DecodedFrame(fmt=dst, width=w, height=h,
                        planes=[p.astype(dt) for p in out])
