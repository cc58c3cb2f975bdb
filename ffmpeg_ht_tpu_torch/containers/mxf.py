"""MXF (SMPTE 377M) demuxer and OP1a muxer for JPEG 2000 essence.

Demux: the reference routes IMF/DCP-style MXF through
libavformat/mxfdec.c (JPEG2000 essence ULs at mxfdec.c:1617,1647). The
demuxer here is a compact KLV walker: it scans the KLV triplet stream
(16-byte UL keys, BER lengths) and yields the generic-container picture
essence elements — frame- or clip-wrapped JPEG 2000 codestreams —
without interpreting the header metadata sets.

Mux: `mux_mxf` writes a single-video-track OP1a file in the reference's
structure (mxfenc.c:3195-3260): closed header partition + primer +
header metadata tree (Preface, Identification, ContentStorage,
MaterialPackage/SourcePackage with Track -> Sequence -> SourceClip,
CDCI descriptor, EssenceContainerData), frame-wrapped essence KLVs, and
a footer partition with RIP. Output is validated against the reference
demuxer+decoder in tests/test_containers.py.
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Sequence

# SMPTE 336M KLV key prefix for MXF (06.0E.2B.34)
_MXF_PREFIX = b"\x06\x0e\x2b\x34"
# partition pack key prefix (06.0E.2B.34.02.05.01.01.0D.01.02)
_PARTITION = b"\x06\x0e\x2b\x34\x02\x05\x01\x01\x0d\x01\x02"
# generic container essence element key prefix
# (06.0E.2B.34.01.02.01.xx.0D.01.03.01) — byte 12 is the item type:
# 0x05 = CP picture, 0x15 = GC picture (JPEG 2000 uses 0x15, element
# types 0x08/0x09, mxfenc.c)
_GC_ESSENCE = b"\x06\x0e\x2b\x34\x01\x02\x01"


def _ber_length(data: bytes, pos: int):
    """BER length at pos -> (length, new_pos)."""
    b = data[pos]
    pos += 1
    if b < 0x80:
        return b, pos
    n = b & 0x7F
    if n == 0 or n > 8 or pos + n > len(data):
        raise ValueError("bad BER length")
    return int.from_bytes(data[pos:pos + n], "big"), pos + n


def probe_mxf(data: bytes) -> bool:
    """A header partition pack within the first 64KiB (mxfdec probe)."""
    return data.find(_PARTITION, 0, 1 << 16) >= 0


def _is_picture_essence(key: bytes) -> bool:
    if not key.startswith(_GC_ESSENCE):
        return False
    if key[8:12] != b"\x0d\x01\x03\x01":
        return False
    item_type = key[12]
    return item_type in (0x05, 0x15)  # CP / GC picture item


# ---------------------------------------------------------------------------
# muxer (OP1a, frame-wrapped JPEG 2000, single video track)
# ---------------------------------------------------------------------------

# SMPTE ULs (spec constants; layout mirrored from mxfenc.c:278-300,215-219)
_OP1A = bytes([0x06, 0x0E, 0x2B, 0x34, 0x04, 0x01, 0x01, 0x01,
               0x0D, 0x01, 0x02, 0x01, 0x01, 0x01, 0x09, 0x00])
_EC_J2K = bytes([0x06, 0x0E, 0x2B, 0x34, 0x04, 0x01, 0x01, 0x07,
                 0x0D, 0x01, 0x03, 0x01, 0x02, 0x0C, 0x01, 0x00])
# byte 14 is the ST 422 wrapping kind: 0x01 frame-, 0x02 clip-wrapped
_EC_J2K_CLIP = _EC_J2K[:14] + bytes([0x02, 0x00])
_CODING_J2K = bytes([0x06, 0x0E, 0x2B, 0x34, 0x04, 0x01, 0x01, 0x07,
                     0x04, 0x01, 0x02, 0x02, 0x03, 0x01, 0x01, 0x00])
_ELEM_J2K = bytes([0x06, 0x0E, 0x2B, 0x34, 0x01, 0x02, 0x01, 0x01,
                   0x0D, 0x01, 0x03, 0x01, 0x15, 0x01, 0x08, 0x00])
_DATADEF_PICTURE = bytes([0x06, 0x0E, 0x2B, 0x34, 0x04, 0x01, 0x01, 0x01,
                          0x01, 0x03, 0x02, 0x02, 0x01, 0x00, 0x00, 0x00])
# header ClosedComplete (mxfenc.c:286), footer ClosedComplete (:282)
_HEADER_PARTITION = _PARTITION + bytes([0x01, 0x01, 0x02, 0x04, 0x00])
_FOOTER_PARTITION = _PARTITION + bytes([0x01, 0x01, 0x04, 0x04, 0x00])
_PRIMER = bytes([0x06, 0x0E, 0x2B, 0x34, 0x02, 0x05, 0x01, 0x01,
                 0x0D, 0x01, 0x02, 0x01, 0x01, 0x05, 0x01, 0x00])
_RIP_KEY = bytes([0x06, 0x0E, 0x2B, 0x34, 0x02, 0x05, 0x01, 0x01,
                  0x0D, 0x01, 0x02, 0x01, 0x01, 0x11, 0x01, 0x00])


def _set_key(low: int) -> bytes:
    """Header metadata set key (mxfdec.c:3264-3306 table, byte 14)."""
    return bytes([0x06, 0x0E, 0x2B, 0x34, 0x02, 0x53, 0x01, 0x01,
                  0x0D, 0x01, 0x01, 0x01, 0x01, 0x01, low, 0x00])


def _ber4(n: int) -> bytes:
    """4-byte long-form BER length (mxfenc klv_encode_ber4_length)."""
    return bytes([0x83]) + n.to_bytes(3, "big")


def _uid(n: int) -> bytes:
    """Deterministic 16-byte instance UID (content-addressed files)."""
    return b"\x8a\x2b\x00\x00" + n.to_bytes(12, "big")


def _umid(n: int) -> bytes:
    """32-byte UMID: SMPTE 330M prefix + 16-byte material number."""
    pre = bytes([0x06, 0x0A, 0x2B, 0x34, 0x01, 0x01, 0x01, 0x05,
                 0x01, 0x01, 0x0D, 0x20, 0x13, 0x00, 0x00, 0x00])
    return pre + _uid(0x100 + n)


def _local(tag: int, val: bytes) -> bytes:
    return struct.pack(">HH", tag, len(val)) + val


def _batch(items: Sequence[bytes]) -> bytes:
    assert items
    return struct.pack(">II", len(items), len(items[0])) + b"".join(items)


def _metaset(key: bytes, payload: bytes) -> bytes:
    return key + _ber4(len(payload)) + payload


def _partition_pack(key: bytes, this: int, prev: int, footer: int,
                    header_bytes: int, body_sid: int,
                    body_offset: int = 0, index_bytes: int = 0,
                    index_sid: int = 0) -> bytes:
    v = struct.pack(">HHI", 1, 3, 1)                  # ver 1.3, KAG 1
    v += struct.pack(">QQQ", this, prev, footer)
    v += struct.pack(">QQ", header_bytes, index_bytes)
    v += struct.pack(">I", index_sid)
    v += struct.pack(">QI", body_offset, body_sid)
    v += _OP1A
    v += _batch([_EC_J2K])   # partition pack: frame UL (informative)
    return key + _ber4(len(v)) + v


_INDEX_SEGMENT = bytes([0x06, 0x0E, 0x2B, 0x34, 0x02, 0x53, 0x01, 0x01,
                        0x0D, 0x01, 0x02, 0x01, 0x01, 0x10, 0x01, 0x00])


def _index_table(edit_rate, nframes: int, offsets: List[int]) -> bytes:
    """VBR IndexTableSegment with one entry per frame (mxfdec.c:1273-1330
    reads exactly these tags; entries are 11-byte
    TemporalOffset/KeyFrameOffset/Flags/StreamOffset rows)."""
    entries = b"".join(struct.pack(">bbBQ", 0, 0, 0x80, off)
                       for off in offsets)
    payload = _local(0x3C0A, _uid(0x70))
    payload += _local(0x3F0B, struct.pack(">II", *edit_rate))
    payload += _local(0x3F0C, struct.pack(">Q", 0))   # IndexStartPosition
    payload += _local(0x3F0D, struct.pack(">Q", nframes))
    payload += _local(0x3F05, struct.pack(">I", 0))   # EditUnitByteCount
    payload += _local(0x3F06, struct.pack(">I", 1))   # IndexSID
    payload += _local(0x3F07, struct.pack(">I", 1))   # BodySID
    payload += _local(0x3F0A, struct.pack(">II", len(offsets), 11)
                      + entries)
    return _metaset(_INDEX_SEGMENT, payload)


def mux_mxf(frames: List[bytes], width: int, height: int,
            ncomp: int = 1, depth: int = 8,
            edit_rate=(25, 1), chroma_shifts=(0, 0),
            wrapping: str = "frame") -> bytes:
    """Wrap JPEG 2000 codestreams as an OP1a MXF file.

    wrapping="frame": one essence KLV per codestream (default);
    "clip": a single essence KLV holding every codestream back to back
    (ST 422 clip wrapping — EssenceContainer UL byte 14 flips to 0x02;
    mxfdec.c ClipWrapped analog). Structure per mxfenc.c:3195-3260;
    metadata tree limited to the sets and local tags the reference
    demuxer resolves (mxfdec.c:1060-1230,1335-1420)."""
    if wrapping not in ("frame", "clip"):
        raise ValueError(f"unknown wrapping {wrapping!r}")
    ec_ul = _EC_J2K_CLIP if wrapping == "clip" else _EC_J2K
    nframes = len(frames)
    rate = struct.pack(">II", edit_rate[0], edit_rate[1])
    dur = struct.pack(">Q", nframes)
    mat_umid = _umid(1)
    src_umid = _umid(2)
    track_number = bytes([0x15, 0x01, 0x08, 0x00])

    sets = []

    def add(key_low, n, *fields):
        payload = _local(0x3C0A, _uid(n))             # InstanceUID
        for tag, val in fields:
            payload += _local(tag, val)
        sets.append(_metaset(_set_key(key_low), payload))
        return _uid(n)

    # Preface -> ContentStorage; Identification (informative)
    ident = add(0x30, 2, (0x3C09, _uid(0x90)),
                (0x3C01, "ffmpeg_ht_tpu".encode("utf-16-be")))
    content = _uid(3)
    add(0x2F, 1,
        (0x3B02, bytes(8)),                           # LastModifiedDate
        (0x3B05, struct.pack(">HH", 1, 3)),           # Version
        (0x3B06, _batch([ident])),                    # Identifications
        (0x3B03, content),                            # ContentStorage
        (0x3B09, _OP1A),                              # OperationalPattern
        (0x3B0A, _batch([ec_ul])))                    # EssenceContainers
    # ContentStorage -> packages + essence container data
    mat_pkg, src_pkg, ecd = _uid(4), _uid(5), _uid(6)
    add(0x18, 3, (0x1901, _batch([mat_pkg, src_pkg])),
        (0x1902, _batch([ecd])))
    add(0x23, 6, (0x2701, src_umid),                  # EssenceContainerData
        (0x3F06, struct.pack(">I", 1)),               # IndexSID
        (0x3F07, struct.pack(">I", 1)))               # BodySID

    def package(key_low, n, umid, track_n, seq_n, clip_n, src,
                descriptor=None):
        # SourceClip: material package points into the source package;
        # the source package terminates with the null UMID (mxfenc.c)
        clip = add(0x11, clip_n,
                   (0x0201, _DATADEF_PICTURE),
                   (0x0202, dur),
                   (0x1201, struct.pack(">Q", 0)),    # StartPosition
                   (0x1101, src[0]),                  # SourcePackageID
                   (0x1102, struct.pack(">I", src[1])))
        seq = add(0x0F, seq_n,
                  (0x0201, _DATADEF_PICTURE),
                  (0x0202, dur),
                  (0x1001, _batch([clip])))
        track = add(0x3B, track_n,
                    (0x4801, struct.pack(">I", 2)),   # TrackID
                    (0x4804, track_number),           # TrackNumber
                    (0x4B01, rate),                   # EditRate
                    (0x4B02, struct.pack(">Q", 0)),   # Origin
                    (0x4803, seq))                    # Sequence
        fields = [(0x4401, umid),                     # PackageUID (UMID)
                  (0x4405, bytes(8)), (0x4404, bytes(8)),  # dates
                  (0x4403, _batch([track]))]          # Tracks
        if descriptor is not None:
            fields.append((0x4701, descriptor))
        add(key_low, n, *fields)

    desc = add(0x28, 7,                               # CDCI descriptor
               (0x3006, struct.pack(">I", 2)),        # LinkedTrackID
               (0x3001, rate),                        # SampleRate
               (0x3004, ec_ul),                       # EssenceContainer
               (0x3201, _CODING_J2K),                 # PictureEssenceCoding
               (0x3203, struct.pack(">I", width)),
               (0x3202, struct.pack(">I", height)),
               (0x320C, bytes([0])),                  # FrameLayout
               (0x320E, struct.pack(">II", width, height)),  # Aspect
               (0x3301, struct.pack(">I", depth)),    # ComponentDepth
               # sub-sampling from the real chroma shifts (2 for 4:2:x);
               # mxfdec.c:1402-1412 reads both tags for pix_fmt choice
               (0x3302, struct.pack(">I",             # HorizSubsampling
                                    1 << chroma_shifts[0])),
               (0x3308, struct.pack(">I",             # VertSubsampling
                                    1 << chroma_shifts[1])))
    package(0x36, 4, mat_umid, 0x20, 0x21, 0x22, (src_umid, 2))
    package(0x37, 5, src_umid, 0x30, 0x31, 0x32, (bytes(32), 0),
            descriptor=desc)

    # primer pack: empty dynamic-tag table (all our tags are the SMPTE
    # static ones the reference reads directly, mxfdec.c:1060-1420)
    primer = _PRIMER + _ber4(8) + struct.pack(">II", 0, 18)
    header_meta = primer + b"".join(sets)

    out = bytearray()
    out += _partition_pack(_HEADER_PARTITION, 0, 0, 0,  # footer patched
                           len(header_meta), 1)
    hdr_pack_len = len(out)
    out += header_meta
    body_start = len(out)
    offsets = []
    if wrapping == "clip":
        # one KLV with every codestream back to back; index offsets are
        # edit-unit byte positions inside the clip payload
        payload = b"".join(bytes(f) for f in frames)
        off = 0
        for f in frames:
            offsets.append(off)
            off += len(f)
        out += _ELEM_J2K + _ber4(len(payload)) + payload
    else:
        for f in frames:
            offsets.append(len(out) - body_start)
            out += _ELEM_J2K + _ber4(len(f)) + bytes(f)
    footer_off = len(out)
    index = _index_table(edit_rate, nframes, offsets)
    out += _partition_pack(_FOOTER_PARTITION, footer_off, 0, footer_off,
                           0, 0, index_bytes=len(index), index_sid=1)
    out += index
    # Random Index Pack: (BodySID, offset) pairs + total RIP length
    rip = struct.pack(">IQ", 0, 0) + struct.pack(">IQ", 1, body_start) \
        + struct.pack(">IQ", 0, footer_off)
    rip_len = 16 + 4 + len(rip) + 4
    out += _RIP_KEY + _ber4(len(rip) + 4) + rip + struct.pack(">I", rip_len)
    # patch the footer-partition offset into the header partition pack
    hdr = _partition_pack(_HEADER_PARTITION, 0, 0, footer_off,
                          len(header_meta), 1)
    assert len(hdr) == hdr_pack_len
    out[:hdr_pack_len] = hdr
    return bytes(out)


def demux_mxf(data: bytes) -> Iterator[bytes]:
    """Yield JPEG 2000 codestream frames from an MXF file."""
    pos = data.find(_PARTITION)
    if pos < 0:
        raise ValueError("not an MXF file (no partition pack)")
    n = len(data)
    while pos + 17 <= n:
        key = data[pos:pos + 16]
        if not key.startswith(_MXF_PREFIX):
            # resync: look for the next KLV key
            nxt = data.find(_MXF_PREFIX, pos + 1)
            if nxt < 0:
                return
            pos = nxt
            continue
        try:
            length, vpos = _ber_length(data, pos + 16)
        except (ValueError, IndexError):
            return
        if vpos + length > n:
            return
        if _is_picture_essence(key):
            payload = data[vpos:vpos + length]
            if payload[:2] == b"\xff\x4f":
                # clip-wrapped essence is one KLV holding the whole
                # stream's codestreams back to back (mxfdec.c
                # ClipWrapped); split on SOC..EOC like the raw-stream
                # frame parser. A frame-wrapped KLV is the degenerate
                # one-frame case of the same split.
                if payload.count(b"\xff\x4f\xff\x51") > 1:
                    from ffmpeg_ht_tpu_torch.containers.frame_parser import \
                        split_frames
                    for frame in split_frames(payload):
                        yield frame
                else:
                    yield payload
            elif payload[:4] == b"\x00\x00\x00\x0c":
                yield payload      # JP2-boxed essence
        pos = vpos + length
