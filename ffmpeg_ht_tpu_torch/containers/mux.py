"""Output muxers — deterministic probes and file writers.

framecrc / framemd5 byte-match the reference muxers
(libavformat/framecrcenc.c, hashenc.c) under -flags +bitexact — they are
the golden-output formats FATE compares on (tests/fate-run.sh:156-166),
so this module is what makes `jxt` outputs diffable against `ffmpeg`
outputs and the checked-in FATE refs.
"""

from __future__ import annotations

import hashlib
import zlib
from typing import List

from ffmpeg_ht_tpu_torch.models.host_decoder import DecodedFrame


def _headers(frame: DecodedFrame, timebase=(1, 25)) -> List[str]:
    return [
        f"#tb 0: {timebase[0]}/{timebase[1]}",
        "#media_type 0: video",
        "#codec_id 0: rawvideo",
        f"#dimensions 0: {frame.width}x{frame.height}",
        "#sar 0: 0/1",
    ]


def framecrc(frames: List[DecodedFrame]) -> str:
    """framecrc muxer output (framecrcenc.c: per-frame Adler-32)."""
    out = _headers(frames[0])
    for i, f in enumerate(frames):
        data = f.tobytes()
        crc = zlib.adler32(data, 0)  # av_adler32_update seeds with 0
        out.append(f"0, {i:10d}, {i:10d}, {1:8d}, {len(data):8d}, "
                   f"0x{crc:08x}")
    return "\n".join(out) + "\n"


def framemd5(frames: List[DecodedFrame]) -> str:
    """framemd5 muxer output (hashenc.c, version 2)."""
    out = ["#format: frame checksums", "#version: 2", "#hash: MD5"]
    out += _headers(frames[0])
    out.append("#stream#, dts,        pts, duration,     size, hash")
    for i, f in enumerate(frames):
        data = f.tobytes()
        md5 = hashlib.md5(data).hexdigest()
        out.append(f"0, {i:10d}, {i:10d}, {1:8d}, {len(data):8d}, {md5}")
    return "\n".join(out) + "\n"


def rawvideo(frames: List[DecodedFrame]) -> bytes:
    return b"".join(f.tobytes() for f in frames)


def md5_total(frames: List[DecodedFrame]) -> str:
    """md5 muxer: one hash over all frame data (hashenc.c)."""
    h = hashlib.md5()
    for f in frames:
        h.update(f.tobytes())
    return f"MD5={h.hexdigest()}\n"
