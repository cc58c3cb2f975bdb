"""Pixel-format negotiation and frame packing.

Replicates the reference's SIZ -> AVPixelFormat negotiation
(jpeg2000dec.c:133-421) and write_frame_8/16 (jpeg2000dec.c:2301-2364) for
the formats the workload uses. Frames are emitted in ffmpeg rawvideo byte
layout so golden comparisons against `ffmpeg -f rawvideo` are byte-exact.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ffmpeg_ht_tpu_torch.utils.errors import PatchWelcome


@dataclass(frozen=True)
class PixFmt:
    name: str
    nb_components: int
    depths: Tuple[int, ...]        # per-component container depth
    log2_chroma_w: int
    log2_chroma_h: int
    planar: bool
    bytes_per_sample: int          # 1 or 2 (little-endian for 2)

    @property
    def pixelsize(self) -> int:
        return 1 if self.planar else self.nb_components


def _yuv(name, depth, cw, ch):
    return PixFmt(name, 3, (depth,) * 3, cw, ch, True, 1 if depth <= 8 else 2)


# ordered candidate lists (jpeg2000dec.c:168-193); lower bpp before higher
RGB_FMTS = [
    PixFmt("rgb24", 3, (8, 8, 8), 0, 0, False, 1),
    PixFmt("rgba", 4, (8, 8, 8, 8), 0, 0, False, 1),
    PixFmt("rgb48le", 3, (16, 16, 16), 0, 0, False, 2),
    PixFmt("rgba64le", 4, (16, 16, 16, 16), 0, 0, False, 2),
]
GRAY_FMTS = [
    PixFmt("gray", 1, (8,), 0, 0, True, 1),
    PixFmt("ya8", 2, (8, 8), 0, 0, False, 1),
    PixFmt("gray16le", 1, (16,), 0, 0, True, 2),
    PixFmt("ya16le", 2, (16, 16), 0, 0, False, 2),
]
YUV_FMTS = [
    _yuv("yuv410p", 8, 2, 2), _yuv("yuv411p", 8, 2, 0),
    _yuv("yuv420p", 8, 1, 1), _yuv("yuv422p", 8, 1, 0),
    _yuv("yuv440p", 8, 0, 1), _yuv("yuv444p", 8, 0, 0),
    _yuv("yuv420p9le", 9, 1, 1), _yuv("yuv422p9le", 9, 1, 0),
    _yuv("yuv444p9le", 9, 0, 0),
    _yuv("yuv420p10le", 10, 1, 1), _yuv("yuv422p10le", 10, 1, 0),
    _yuv("yuv444p10le", 10, 0, 0),
    _yuv("yuv420p12le", 12, 1, 1), _yuv("yuv422p12le", 12, 1, 0),
    _yuv("yuv444p12le", 12, 0, 0),
    _yuv("yuv420p14le", 14, 1, 1), _yuv("yuv422p14le", 14, 1, 0),
    _yuv("yuv444p14le", 14, 0, 0),
    _yuv("yuv420p16le", 16, 1, 1), _yuv("yuv422p16le", 16, 1, 0),
    _yuv("yuv444p16le", 16, 0, 0),
]
XYZ_FMTS = [PixFmt("xyz12le", 3, (12, 12, 12), 0, 0, False, 2)]
ALL_FMTS = RGB_FMTS + GRAY_FMTS + YUV_FMTS + XYZ_FMTS

PROFILE_DCINEMA_2K = 3
PROFILE_DCINEMA_4K = 4


def _match(fmt: PixFmt, ncomp: int, bpc: int, log2_chroma_wh: int) -> bool:
    """pix_fmt_match parity (jpeg2000dec.c:133-166)."""
    if fmt.nb_components != ncomp:
        return False
    ok = True
    if ncomp >= 4:
        ok &= fmt.depths[3] >= bpc \
            and (log2_chroma_wh >> 14 & 3) == 0 and (log2_chroma_wh >> 12 & 3) == 0
    if ncomp >= 3:
        ok &= fmt.depths[2] >= bpc \
            and (log2_chroma_wh >> 10 & 3) == fmt.log2_chroma_w \
            and (log2_chroma_wh >> 8 & 3) == fmt.log2_chroma_h
    if ncomp >= 2:
        ok &= fmt.depths[1] >= bpc \
            and (log2_chroma_wh >> 6 & 3) == fmt.log2_chroma_w \
            and (log2_chroma_wh >> 4 & 3) == fmt.log2_chroma_h
    ok &= fmt.depths[0] >= bpc \
        and (log2_chroma_wh >> 2 & 3) == 0 and (log2_chroma_wh & 3) == 0
    return bool(ok)


def negotiate(siz, colour_space: int, profile: int) -> PixFmt:
    """SIZ -> pixel format (get_siz, jpeg2000dec.c:314-419)."""
    ncomp = siz.ncomponents
    bpc = siz.precision
    log2_chroma_wh = 0
    for i, c in enumerate(siz.components):
        log2_chroma_wh |= (c.dy >> 1) << (i * 4) | (c.dx >> 1) << (i * 4 + 2)

    if profile in (PROFILE_DCINEMA_2K, PROFILE_DCINEMA_4K):
        candidates = XYZ_FMTS + YUV_FMTS
    elif colour_space == 16:
        candidates = RGB_FMTS
    elif colour_space == 17:
        candidates = GRAY_FMTS
    elif colour_space == 18:
        candidates = YUV_FMTS
    else:
        candidates = ALL_FMTS

    for fmt in candidates:
        if _match(fmt, ncomp, bpc, log2_chroma_wh):
            return fmt

    # fallbacks (jpeg2000dec.c:365-398)
    cd = siz.components
    if ncomp == 3 and bpc == 8 \
            and cd[0].dx == cd[1].dx == cd[2].dx \
            and cd[0].dy == cd[1].dy == cd[2].dy:
        return PixFmt("rgb24", 3, (8, 8, 8), 0, 0, False, 1)
    if ncomp == 1 and bpc == 8:
        return GRAY_FMTS[0]
    if ncomp == 1 and bpc == 12:
        return PixFmt("gray16le", 1, (16,), 0, 0, True, 2)
    raise PatchWelcome(
        f"Unknown pix_fmt: comps={ncomp} precision={bpc} cs={colour_space}")


def output_precision(fmt: PixFmt, precision: int) -> int:
    """write_frame bit-depth selection (jpeg2000dec.c:2383-2391)."""
    if precision <= 8:
        return 8
    if fmt.name in ("xyz12le", "rgb48le", "rgba64le", "gray16le"):
        return 16
    return precision


def frame_shapes(fmt: PixFmt, width: int,
                 height: int) -> List[Tuple[int, int]]:
    """(rows, samples a row) of each plane of a frame in rawvideo layout."""
    if not fmt.planar:
        return [(height, width * fmt.nb_components)]
    return [(-(-height >> fmt.log2_chroma_h) if i in (1, 2) else height,
             -(-width >> fmt.log2_chroma_w) if i in (1, 2) else width)
            for i in range(fmt.nb_components)]


def alloc_frame(fmt: PixFmt, width: int, height: int) -> List[np.ndarray]:
    """Allocate per-plane arrays in rawvideo layout."""
    dt = np.uint8 if fmt.bytes_per_sample == 1 else np.uint16
    return [np.zeros(shape, dtype=dt)
            for shape in frame_shapes(fmt, width, height)]


def pack_rawvideo(fmt: PixFmt, planes: List[np.ndarray]) -> bytes:
    """Serialize planes in ffmpeg rawvideo order (little-endian 16-bit)."""
    out = bytearray()
    for p in planes:
        if p.dtype == np.uint16:
            out += p.astype("<u2").tobytes()
        else:
            out += p.tobytes()
    return bytes(out)
