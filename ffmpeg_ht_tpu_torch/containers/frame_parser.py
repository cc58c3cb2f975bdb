"""Codestream frame splitter — the stream-parser tier.

Splits a raw byte stream into whole J2K/JP2 frames for the demux layer.
Behavior parity: ff_jpeg2000_parser / find_frame_end
(/root/reference/libavcodec/jpeg2000_parser.c:93-186): length-aware
marker-segment skipping, JP2 signature detection, SOT Psot skipping and
EOC detection, tolerant of garbage between frames.
"""

from __future__ import annotations

from typing import Iterator, Optional

_JP2_SIG = b"\x00\x00\x00\x0cjP\x20\x20\x0d\x0a\x87\x0a"
_SOC = 0xFF4F
_EOC = 0xFFD9
_SOT = 0xFF90
_SOD = 0xFF93
# marker segments with no length field
_NO_LEN = {0xFF4F, 0xFF93, 0xFFD9, 0xFF92}  # SOC, SOD, EOC, EPH


class FrameParser:
    """Incremental frame splitter. Feed bytes, get whole frames out."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> Iterator[bytes]:
        self._buf.extend(data)
        while True:
            frame = self._extract()
            if frame is None:
                return
            yield frame

    def flush(self) -> Optional[bytes]:
        """Return any trailing partial frame (EOC may be missing —
        jpeg2000dec.c:2492 degrades that to a warning)."""
        buf = bytes(self._buf)
        self._buf.clear()
        start = _find_start(buf)
        if start is None:
            return None
        return buf[start:] or None

    def _extract(self) -> Optional[bytes]:
        buf = self._buf
        start = _find_start(bytes(buf))
        if start is None:
            # keep a tail in case a signature straddles the boundary
            if len(buf) > 16:
                del buf[:-16]
            return None
        if start:
            del buf[:start]
        end = _find_frame_end(bytes(buf))
        if end is None:
            return None
        frame = bytes(buf[:end])
        del buf[:end]
        return frame


def _find_start(buf: bytes) -> Optional[int]:
    """First JP2 signature or SOC marker position."""
    sig = buf.find(_JP2_SIG)
    soc = buf.find(b"\xff\x4f\xff\x51")  # SOC immediately followed by SIZ
    cands = [p for p in (sig, soc) if p >= 0]
    return min(cands) if cands else None


def _find_frame_end(buf: bytes) -> Optional[int]:
    """Offset one past EOC of the first complete frame, else None."""
    pos = 0
    n = len(buf)
    if buf.startswith(_JP2_SIG):
        # walk JP2 boxes to the jp2c codestream box
        pos = 0
        while pos + 8 <= n:
            size = int.from_bytes(buf[pos:pos + 4], "big")
            tag = buf[pos + 4:pos + 8]
            if tag == b"jp2c":
                return _scan_codestream(buf, pos + 8)
            if size == 0:
                return None
            if size == 1:
                if pos + 16 > n:
                    return None
                size = int.from_bytes(buf[pos + 8:pos + 16], "big")
            if size < 8:
                return None
            pos += size
        return None
    return _scan_codestream(buf, 0)


def _scan_codestream(buf: bytes, pos: int) -> Optional[int]:
    """Marker walk from SOC to EOC (length-aware, Psot skip)."""
    n = len(buf)
    if pos + 2 > n or buf[pos] != 0xFF or buf[pos + 1] != 0x4F:
        return None
    pos += 2
    while pos + 2 <= n:
        if buf[pos] != 0xFF:
            return None  # desync: caller resyncs on next SOC
        marker = (buf[pos] << 8) | buf[pos + 1]
        if marker == _EOC:
            return pos + 2
        if marker == _SOT:
            # Psot (jpeg2000_parser.c: skip the whole tile-part)
            if pos + 12 > n:
                return None
            psot = int.from_bytes(buf[pos + 6:pos + 10], "big")
            if psot == 0:
                # tile-part extends to EOC: scan for it after SOD
                idx = buf.find(b"\xff\xd9", pos)
                return idx + 2 if idx >= 0 else None
            pos += psot
            continue
        if marker in _NO_LEN:
            pos += 2
            continue
        if pos + 4 > n:
            return None
        seg = int.from_bytes(buf[pos + 2:pos + 4], "big")
        if seg < 2:
            return None
        pos += 2 + seg
    return None


def split_frames(data: bytes):
    """One-shot split of a whole byte stream into frames."""
    p = FrameParser()
    frames = list(p.feed(data))
    tail = p.flush()
    if tail:
        frames.append(tail)
    return frames
