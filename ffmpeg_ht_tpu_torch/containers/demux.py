"""Input probing and demuxing — the container tier.

Covers the reference's JPEG 2000 entry points (SURVEY.md §2.3):
single-image files and %d sequences (img2dec.c:749-757, probe on the JP2
signature or a raw SOC+SIZ), raw Motion-JPEG2000 elementary streams
(mj2kdec.c:26-52, repeated SOC+SIZ), and MOV/MJ2 (isom_tags.c:215 via
containers/mov.py).
"""

from __future__ import annotations

import glob
import os
import re
from typing import Iterator

from ffmpeg_ht_tpu_torch.containers import mov, mxf
from ffmpeg_ht_tpu_torch.containers.frame_parser import split_frames

_JP2_SIG = b"\x00\x00\x00\x0cjP\x20\x20\x0d\x0a\x87\x0a"


def probe_bytes(data: bytes) -> str:
    """Return a format name: j2k | jp2 | mjpeg_2000 | mov | unknown."""
    if data.startswith(_JP2_SIG):
        return "jp2"
    if data.startswith(b"\xff\x4f\xff\x51"):
        # repeated SOC+SIZ after the first frame => raw MJ2K stream
        frames = split_frames(data[:1 << 20])
        if len(frames) > 1 or (frames and len(frames[0]) < len(data) - 16):
            return "mjpeg_2000"
        return "j2k"
    if mov.probe_mov(data):
        return "mov"
    if mxf.probe_mxf(data):
        return "mxf"
    return "unknown"


def probe_file(path: str) -> str:
    with open(path, "rb") as f:
        head = f.read(1 << 20)
    fmt = probe_bytes(head)
    if fmt == "unknown" and "%" in path:
        return "image2"
    return fmt


def demux_file(path: str) -> Iterator[bytes]:
    """Yield one codestream (J2C/JP2 bytes) per frame."""
    if "%" in os.path.basename(path):
        # image2-style %d sequence (img2dec.c sequence input)
        pattern = re.sub(r"%0?(\d*)d", "*", os.path.basename(path))
        folder = os.path.dirname(path) or "."
        for p in sorted(glob.glob(os.path.join(folder, pattern))):
            with open(p, "rb") as f:
                yield f.read()
        return
    with open(path, "rb") as f:
        data = f.read()
    yield from demux_bytes(data)


def demux_bytes(data: bytes) -> Iterator[bytes]:
    fmt = probe_bytes(data)
    if fmt == "mov":
        yield from mov.demux_mov(data)
    elif fmt == "mxf":
        yield from mxf.demux_mxf(data)
    elif fmt in ("j2k", "jp2"):
        frames = split_frames(data)
        if frames:
            yield from frames
        else:
            yield data
    elif fmt == "mjpeg_2000":
        yield from split_frames(data)
    else:
        raise ValueError("unrecognized input format")
