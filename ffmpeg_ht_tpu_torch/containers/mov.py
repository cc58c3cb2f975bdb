"""Minimal ISO-BMFF (MOV/MJ2) reader and writer for Motion JPEG 2000.

Demux parity: the reference routes 'mjp2' tracks through
libavformat/mov (isom_tags.c:215) — here a compact box walker extracts
the video track's sample table (stsd/stsz/stco/co64/stsc) and yields
codestream samples. The writer emits a minimal but spec-conforming MJ2
file (ftyp 'mjp2' + mdat + moov) that the reference `ffmpeg` demuxes —
cross-checked in tests/test_containers.py.
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Optional, Tuple


def _be32(v):
    return struct.pack(">I", v)


def _walk(data: bytes, start: int, end: int):
    pos = start
    while pos + 8 <= end:
        size = int.from_bytes(data[pos:pos + 4], "big")
        tag = data[pos + 4:pos + 8]
        hdr = 8
        if size == 1:
            size = int.from_bytes(data[pos + 8:pos + 16], "big")
            hdr = 16
        elif size == 0:
            size = end - pos
        if size < hdr or pos + size > end:
            return
        yield tag, pos + hdr, pos + size
        pos += size


def _find(data, start, end, *path):
    if not path:
        yield (start, end)
        return
    for tag, s, e in _walk(data, start, end):
        if tag == path[0]:
            yield from _find(data, s, e, *path[1:])


def probe_mov(data: bytes) -> bool:
    if len(data) < 12:
        return False
    tag = data[4:8]
    return tag in (b"ftyp", b"moov", b"mdat", b"wide", b"free", b"skip")


def demux_mov(data: bytes) -> Iterator[bytes]:
    """Yield mjp2/jpeg2000 video samples from a MOV/MJ2 file."""
    for moov_s, moov_e in _find(data, 0, len(data), b"moov"):
        for trak_s, trak_e in _find(data, moov_s, moov_e, b"trak"):
            stbl = list(_find(data, trak_s, trak_e,
                              b"mdia", b"minf", b"stbl"))
            if not stbl:
                continue
            s, e = stbl[0]
            fourcc = None
            for ss, se in _find(data, s, e, b"stsd"):
                if se - ss >= 16:
                    fourcc = data[ss + 12:ss + 16]
            if fourcc not in (b"mjp2", b"mj2c"):
                continue
            sizes = _read_stsz(data, s, e)
            offsets = _read_chunk_offsets(data, s, e)
            spc = _read_stsc(data, s, e)
            if sizes is None or not offsets:
                continue
            # map samples to file offsets via stsc runs
            sample = 0
            nchunks = len(offsets)
            for ci in range(nchunks):
                per = _samples_in_chunk(spc, ci + 1, nchunks)
                off = offsets[ci]
                for _ in range(per):
                    if sample >= len(sizes):
                        return
                    yield data[off:off + sizes[sample]]
                    off += sizes[sample]
                    sample += 1
        return


def _table_count(declared: int, avail: int, entry: int) -> int:
    """Clamp a sample-table entry count to what its box can hold.

    Counts are untrusted 32-bit fields; without the clamp a corrupt
    count allocates a multi-GB list (mov.c bounds entries against the
    remaining atom size the same way)."""
    if declared > avail // entry:
        raise ValueError("sample table overruns its box")
    return declared


def _read_stsz(data, s, e) -> Optional[List[int]]:
    for ss, se in _find(data, s, e, b"stsz"):
        fixed = int.from_bytes(data[ss + 4:ss + 8], "big")
        count = int.from_bytes(data[ss + 8:ss + 12], "big")
        if fixed:
            # no table follows; bound the implied sample count by the
            # file itself so a corrupt count cannot blow up the caller
            if count > len(data):
                raise ValueError("stsz sample count exceeds file size")
            return [fixed] * count
        count = _table_count(count, max(se - ss - 12, 0), 4)
        return [int.from_bytes(data[ss + 12 + 4 * i:ss + 16 + 4 * i], "big")
                for i in range(count)]
    return None


def _read_chunk_offsets(data, s, e) -> List[int]:
    for ss, se in _find(data, s, e, b"stco"):
        count = int.from_bytes(data[ss + 4:ss + 8], "big")
        count = _table_count(count, max(se - ss - 8, 0), 4)
        return [int.from_bytes(data[ss + 8 + 4 * i:ss + 12 + 4 * i], "big")
                for i in range(count)]
    for ss, se in _find(data, s, e, b"co64"):
        count = int.from_bytes(data[ss + 4:ss + 8], "big")
        count = _table_count(count, max(se - ss - 8, 0), 8)
        return [int.from_bytes(data[ss + 8 + 8 * i:ss + 16 + 8 * i], "big")
                for i in range(count)]
    return []


def _read_stsc(data, s, e) -> List[Tuple[int, int]]:
    for ss, se in _find(data, s, e, b"stsc"):
        count = int.from_bytes(data[ss + 4:ss + 8], "big")
        count = _table_count(count, max(se - ss - 8, 0), 12)
        out = []
        for i in range(count):
            base = ss + 8 + 12 * i
            first = int.from_bytes(data[base:base + 4], "big")
            per = int.from_bytes(data[base + 4:base + 8], "big")
            out.append((first, per))
        return out
    return [(1, 1)]


def _samples_in_chunk(spc, chunk_no, nchunks) -> int:
    per = 1
    for first, p in spc:
        if chunk_no >= first:
            per = p
    return per


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def _box(tag: bytes, payload: bytes) -> bytes:
    return _be32(8 + len(payload)) + tag + payload


def mux_mj2(samples: List[bytes], width: int, height: int,
            fps: int = 25) -> bytes:
    """Write a minimal MJ2 (Motion JPEG 2000) file."""
    ftyp = _box(b"ftyp", b"mjp2" + _be32(0) + b"mjp2")
    mdat_payload = b"".join(samples)
    mdat_offset = len(ftyp) + 8
    mdat = _box(b"mdat", mdat_payload)

    timescale = fps
    nsamples = len(samples)
    duration = nsamples

    # sample table
    stsd_entry = _box(b"mjp2", bytes(6) + struct.pack(">H", 1)
                      + bytes(16)
                      + struct.pack(">HH", width, height)
                      + struct.pack(">II", 0x00480000, 0x00480000)
                      + _be32(0) + struct.pack(">H", 1)
                      + bytes(32)
                      + struct.pack(">Hh", 24, -1))
    stsd = _box(b"stsd", _be32(0) + _be32(1) + stsd_entry)
    stts = _box(b"stts", _be32(0) + _be32(1)
                + struct.pack(">II", nsamples, 1))
    stsc = _box(b"stsc", _be32(0) + _be32(1)
                + struct.pack(">III", 1, nsamples, 1))
    stsz = _box(b"stsz", _be32(0) + _be32(0) + _be32(nsamples)
                + b"".join(_be32(len(s)) for s in samples))
    stco = _box(b"stco", _be32(0) + _be32(1) + _be32(mdat_offset))
    stbl = _box(b"stbl", stsd + stts + stsc + stsz + stco)

    vmhd = _box(b"vmhd", _be32(1) + bytes(8))
    dref = _box(b"dref", _be32(0) + _be32(1)
                + _box(b"url ", _be32(1)))
    dinf = _box(b"dinf", dref)
    minf = _box(b"minf", vmhd + dinf + stbl)
    hdlr = _box(b"hdlr", _be32(0) + _be32(0) + b"vide" + bytes(12)
                + b"ffht video\x00")
    mdhd = _box(b"mdhd", _be32(0) + _be32(0) + _be32(0)
                + _be32(timescale) + _be32(duration)
                + struct.pack(">HH", 0x55C4, 0))
    mdia = _box(b"mdia", mdhd + hdlr + minf)
    matrix = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                         0x40000000)
    tkhd = _box(b"tkhd", _be32(7) + _be32(0) + _be32(0) + _be32(1)
                + _be32(0) + _be32(duration) + bytes(8)
                + struct.pack(">hhhh", 0, 0, 0, 0)
                + matrix
                + struct.pack(">II", width << 16, height << 16))
    trak = _box(b"trak", tkhd + mdia)
    mvhd = _box(b"mvhd", _be32(0) + _be32(0) + _be32(0)
                + _be32(timescale) + _be32(duration)
                + _be32(0x00010000) + struct.pack(">H", 0x0100)
                + bytes(10) + matrix + bytes(24) + _be32(2))
    moov = _box(b"moov", mvhd + trak)
    return ftyp + mdat + moov
