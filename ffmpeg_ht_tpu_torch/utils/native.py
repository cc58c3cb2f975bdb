"""ctypes loader for the port's native host-runtime library.

The native tier accelerates the byte/bit-serial host stages that feed the
device program: stream prep (``native/htprep.c``), the packet-header
parser (``t2parse.c``), the multi-layer segment gather (``seggather.c``),
the HT block decoder of the host oracle (``htdec.c``), the legacy
EBCOT/MQ decoder (``ebcot.c``) and the HT cleanup encoder (``htenc.c``).
The sources live in ``ffmpeg_ht_tpu_torch/native``. At first use they are
compiled with ``cc -O3 -shared -fPIC`` into
``build/ffmpeg_ht_tpu_torch/libffhtnative.so`` under the repository root
(to a temporary name, then renamed, so that concurrent processes never
load a half-written library), and rebuilt when a source is newer than
the library. A missing compiler, a failed build or a failed load raises:
the port has no numpy fallback for a missing native tier.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

import numpy as np

from ffmpeg_ht_tpu_torch.utils.build import BUILD_DIR

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
LIB_PATH = os.path.join(BUILD_DIR, "libffhtnative.so")
CC_FLAGS = ("-O3", "-shared", "-fPIC")

_LIB = None
_LOCK = threading.Lock()


def _sources():
    return sorted(glob.glob(os.path.join(NATIVE_DIR, "*.c")))


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > built for s in _sources())


def _compile() -> None:
    cc = shutil.which(os.environ.get("CC", "cc"))
    if cc is None:
        raise RuntimeError("no C compiler (cc): the native tier cannot be "
                           "built")
    srcs = _sources()
    if not srcs:
        raise RuntimeError(f"no C sources under {NATIVE_DIR}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = [cc, *CC_FLAGS, "-o", tmp, *srcs]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError("native tier build failed (exit %d):\n%s\n%s" % (
            res.returncode, " ".join(cmd), res.stderr[-8000:]))
    os.replace(tmp, LIB_PATH)


def load():
    """Build (if stale) and load the native library; cached per process.
    Raises when the build or the load fails."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if _stale():
            _compile()
        lib = ctypes.CDLL(LIB_PATH)
        lib.ht_prepare_streams.restype = ctypes.c_int
        lib.ht_prepare_streams.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        v3_rows = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
        lib.ht_v3_extents.restype = ctypes.c_int
        lib.ht_v3_extents.argtypes = v3_rows + [ctypes.c_void_p] * 3
        lib.ht_v3_pack.restype = ctypes.c_int
        lib.ht_v3_pack.argtypes = v3_rows + [ctypes.c_void_p,
                                             ctypes.c_int64] * 3
        _LIB = lib
        return _LIB


def ht_prepare_streams(data: np.ndarray, lcup: np.ndarray,
                       pcup: np.ndarray, want_limits: bool = False):
    """Native stream prep; returns (msw, melw, vlcw[, ms_lim, mel_lim])
    or None when the C prep reports an error."""
    lib = load()
    data = np.ascontiguousarray(data, np.uint8)
    n, l = data.shape
    lcup = np.ascontiguousarray(lcup, np.int64)
    pcup = np.ascontiguousarray(pcup, np.int64)
    w_cap = (8 * l + 64) // 32 + 3
    msw = np.empty((n, w_cap), np.uint32)       # the C prep writes every word
    melw = np.empty((n, w_cap), np.uint32)
    vlcw = np.empty((n, w_cap), np.uint32)
    maxw = np.zeros(1, np.int64)
    ms_lim = np.zeros(n, np.int32)
    mel_lim = np.zeros(n, np.int32)
    rc = lib.ht_prepare_streams(
        data.ctypes.data, n, l, lcup.ctypes.data, pcup.ctypes.data,
        msw.ctypes.data, melw.ctypes.data, vlcw.ctypes.data,
        w_cap, maxw.ctypes.data, ms_lim.ctypes.data, mel_lim.ctypes.data)
    if rc != 0:
        return None
    # per-stream pow2 widths (matches ht_batch._trim_pow2)
    from ffmpeg_ht_tpu_torch.ops.ht_batch import _trim_pow2
    out = (_trim_pow2(msw), _trim_pow2(melw), _trim_pow2(vlcw))
    return out + (ms_lim, mel_lim) if want_limits else out


def ht_prepare_v3(bodies, off, lcup, pcup, moddcup, counts=None, out=None):
    """The stream words straight from codestream bodies, as
    ``ht_prepare_streams(..., want_limits=True)`` gives them for the byte
    matrix of these rows: (msw, melw, vlcw, ms_lim, mel_lim).

    bodies: uint8 arrays; off, lcup, pcup: (rows,) int64, a row of body k
    reading ``bodies[k][off + j]`` for j < lcup (0 past the body's end);
    moddcup: (rows,) bool, the rows whose last two bytes take modDcup.
    Without `counts` the rows split evenly, rows / len(bodies) to a body
    (the v3 program's frames); with it, body k holds the next counts[k]
    rows (a BucketProgram bucket's lanes from several bodies).
    One pass finds each stream's extent, one writes the words at the width
    ``ht_batch._trim_pow2`` would give them: into new arrays, or with
    `out`, a callable that takes the three word arrays' shapes once the
    first pass has found them, into the arrays it returns (writable
    C-contiguous uint32 of exactly those shapes; every word is written,
    the zero padding included)."""
    from ffmpeg_ht_tpu_torch.ops.ht_batch import _pow2_width
    lib = load()
    bodies = [np.ascontiguousarray(b, np.uint8) for b in bodies]
    rows = len(lcup)
    ptrs = np.array([b.ctypes.data for b in bodies], np.uintp)
    blen = np.array([len(b) for b in bodies], np.int64)
    if counts is not None:
        if len(counts) != len(bodies) or sum(counts) != rows:
            raise ValueError(f"counts {list(counts)} do not cover {rows} "
                             "rows")
        ptrs, blen = np.repeat(ptrs, counts), np.repeat(blen, counts)
    elif not bodies or rows % len(bodies):
        raise ValueError(f"{rows} rows do not split into {len(bodies)} "
                         "frames")
    F = len(ptrs)
    off = np.ascontiguousarray(off, np.int64)
    lcup = np.ascontiguousarray(lcup, np.int64)
    pcup = np.ascontiguousarray(pcup, np.int64)
    moddcup = np.ascontiguousarray(moddcup, np.uint8)
    if not len(off) == len(pcup) == len(moddcup) == rows:
        raise ValueError("row columns of unequal length")
    head = (ptrs.ctypes.data, blen.ctypes.data, F, rows // F if F else 0,
            off.ctypes.data, lcup.ctypes.data, pcup.ctypes.data,
            moddcup.ctypes.data)
    ms_lim = np.empty(rows, np.int32)
    mel_lim = np.empty(rows, np.int32)
    last = np.empty(3, np.int64)
    rc = lib.ht_v3_extents(*head, ms_lim.ctypes.data, mel_lim.ctypes.data,
                           last.ctypes.data)
    if rc == 0:
        shapes = [(rows, _pow2_width(int(w) + 3)) for w in last]
        words = [np.empty(s, np.uint32) for s in shapes] if out is None \
            else list(out(shapes))
        if len(words) != 3 or not all(
                isinstance(a, np.ndarray) and a.dtype == np.uint32
                and a.shape == s and a.flags.c_contiguous
                and a.flags.writeable for a, s in zip(words, shapes)):
            raise ValueError("v3 stream prep: the outputs are not writable "
                             f"C-contiguous uint32 arrays of shapes {shapes}")
        rc = lib.ht_v3_pack(*head, *(x for a in words
                                     for x in (a.ctypes.data, a.shape[1])))
    if rc == -2:
        raise MemoryError("v3 stream prep: no row buffer")
    if rc != 0:
        raise ValueError("v3 stream prep: a lane's pcup lies outside "
                         "[0, lcup]")
    return (*words, ms_lim, mel_lim)


# ---------------------------------------------------------------------------
# HT cleanup encoder (native/htenc.c)
# ---------------------------------------------------------------------------

_ENC_TABLES = None


def _enc_tables():
    """Flatten the inverse CxtVLC tables for the C encoder.

    Layout [tbl][ctx][rho][u_off][cand] of packed uint32
    (cwd | len<<8 | emb_k<<16 | emb_1<<20 | valid<<24); candidate order
    matches ht_enc._pick_entry's iteration order (code ascending) so the
    C tie-breaking selects the identical entry.
    """
    global _ENC_TABLES
    if _ENC_TABLES is not None:
        return _ENC_TABLES
    from ffmpeg_ht_tpu_torch.ops.ht_enc import (_inverse_cxtvlc,
                                          _uvlc_prefix_codes)
    CAND = 16
    flat = np.zeros((2, 8, 16, 2, CAND), np.uint32)
    counts = np.zeros((2, 8, 16, 2), np.int32)
    for tbl in (0, 1):
        inv = _inverse_cxtvlc(tbl)
        for (ctx, r, sp, ek, e1), (cwd, ln) in inv.items():
            c = counts[tbl, ctx, sp, r]
            if c >= CAND:
                # A table change that overflows the candidate capacity must
                # fail loudly — a silent drop would desync the native encoder
                # from the Python encoder (divergent bitstreams).
                raise RuntimeError(
                    "inverse-CxtVLC candidates overflow CAND=%d at "
                    "(tbl=%d,ctx=%d,rho=%d,u_off=%d)" % (CAND, tbl, ctx,
                                                         sp, r))
            flat[tbl, ctx, sp, r, c] = (cwd | (ln << 8) | (ek << 16)
                                        | (e1 << 20) | (1 << 24))
            counts[tbl, ctx, sp, r] = c + 1
    pcodes = _uvlc_prefix_codes()
    pfx_bits = np.zeros(6, np.int32)
    pfx_nb = np.zeros(6, np.int32)
    for val, (bits, nb) in pcodes.items():
        if val < 6:
            pfx_bits[val] = bits
            pfx_nb[val] = nb
    _ENC_TABLES = (np.ascontiguousarray(flat.reshape(-1)), pfx_bits, pfx_nb)
    return _ENC_TABLES


def _bind_encoder(lib):
    if getattr(lib, "_enc_bound", False):
        return
    lib.ht_encode_cleanup.restype = ctypes.c_int64
    lib.ht_encode_cleanup.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib._enc_bound = True


def ht_encode_cleanup(mag: np.ndarray, sign: np.ndarray, zbp: int):
    """Native cleanup encode; returns (dcup bytes, lcup) or None."""
    lib = load()
    _bind_encoder(lib)
    inv, pfx_bits, pfx_nb = _enc_tables()
    h, w = mag.shape
    mag = np.ascontiguousarray(mag, np.int64)
    sign = np.ascontiguousarray(sign, np.int64)
    cap = 8 * w * h + 80
    out = np.zeros(cap + 64, np.uint8)
    scratch = np.zeros(3 * cap, np.uint8)
    lcup = lib.ht_encode_cleanup(
        mag.ctypes.data, sign.ctypes.data, w, h, zbp,
        inv.ctypes.data, pfx_bits.ctypes.data, pfx_nb.ctypes.data,
        out.ctypes.data, scratch.ctypes.data)
    if lcup < 0:
        return None
    return bytes(out[:lcup]), int(lcup)


# ---------------------------------------------------------------------------
# T2 packet-header parser (native/t2parse.c)
# ---------------------------------------------------------------------------

_T2_BOUND = False


def t2_parse_packets(body: bytes, pkt_nband, pkt_csty, pkt_style,
                     pkt_layno, bi_base, bi_cw, bi_ch, bi_magb, bi_tree,
                     n_trees: int, roi_shift: int, ncblks: int,
                     max_segs: int = 1, pph: bytes = None):
    """Native packet-header parse (all quality layers).

    `pph`: packed packet headers (PPM/PPT) — header bits come from this
    buffer, payload bytes from `body` (t2.py's select_header /
    _post_header split). None = inline headers.

    Returns dict of flat per-cblk arrays (seg_off/seg_len are
    (ncblks, max_segs) per-layer payload ranges), or None when the
    stream leaves the supported profile
    (caller falls back to the Python T2). Raises InvalidData on
    malformed headers (error parity with t2.decode_packet)."""
    lib = load()
    global _T2_BOUND
    if not _T2_BOUND:
        lib.t2_parse_packets.restype = ctypes.c_int
        lib.t2_parse_packets.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_int32] \
            + [ctypes.c_void_p] * 9 \
            + [ctypes.c_int32] * 4 + [ctypes.c_void_p] * 10
        _T2_BOUND = True
    npackets = len(pkt_nband)
    o = {k: np.zeros(ncblks, np.int32)
         for k in ("incl", "zbp", "nzb", "npasses", "nseg")}
    o.update({k: np.zeros(ncblks, np.int64)
              for k in ("lcup", "lref", "len")})
    o["seg_off"] = np.zeros((ncblks, max_segs), np.int64)
    o["seg_len"] = np.zeros((ncblks, max_segs), np.int64)
    bodyb = np.frombuffer(body, np.uint8)
    pphb = np.frombuffer(pph, np.uint8) if pph else None
    rc = lib.t2_parse_packets(
        bodyb.ctypes.data, len(body),
        pphb.ctypes.data if pphb is not None else None,
        len(pph) if pph else 0,
        npackets,
        np.ascontiguousarray(pkt_nband, np.int32).ctypes.data,
        np.ascontiguousarray(pkt_csty, np.int32).ctypes.data,
        np.ascontiguousarray(pkt_style, np.int32).ctypes.data,
        np.ascontiguousarray(pkt_layno, np.int32).ctypes.data,
        np.ascontiguousarray(bi_base, np.int32).ctypes.data,
        np.ascontiguousarray(bi_cw, np.int32).ctypes.data,
        np.ascontiguousarray(bi_ch, np.int32).ctypes.data,
        np.ascontiguousarray(bi_magb, np.int32).ctypes.data,
        np.ascontiguousarray(bi_tree, np.int32).ctypes.data,
        n_trees, roi_shift, ncblks, max_segs,
        o["incl"].ctypes.data, o["zbp"].ctypes.data, o["nzb"].ctypes.data,
        o["npasses"].ctypes.data, o["lcup"].ctypes.data,
        o["lref"].ctypes.data,
        o["seg_off"].ctypes.data, o["seg_len"].ctypes.data,
        o["nseg"].ctypes.data, o["len"].ctypes.data)
    if rc == -100:
        return None
    if rc != 0:
        from ffmpeg_ht_tpu_torch.utils.errors import InvalidData
        raise InvalidData("malformed packet headers (native T2)")
    return o


# ---------------------------------------------------------------------------
# Multi-layer segment gather (native/seggather.c)
# ---------------------------------------------------------------------------

_SEG_BOUND = False


def seg_gather(body, seg_off, seg_len, nseg, new_off, out_len: int):
    """Concatenate each codeblock's per-layer segments into one run.

    body: uint8 array; seg_off/seg_len: (N, S) int64; nseg: (N,) int32;
    new_off: (N,) int64 destination offsets. Returns the uint8 output
    buffer."""
    lib = load()
    global _SEG_BOUND
    if not _SEG_BOUND:
        lib.seg_gather.restype = ctypes.c_int
        lib.seg_gather.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int32, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_void_p, ctypes.c_int64]
        _SEG_BOUND = True
    n, max_segs = seg_off.shape
    out = np.zeros(out_len, np.uint8)
    rc = lib.seg_gather(
        body.ctypes.data, len(body),
        np.ascontiguousarray(seg_off, np.int64).ctypes.data,
        np.ascontiguousarray(seg_len, np.int64).ctypes.data,
        max_segs,
        np.ascontiguousarray(nseg, np.int32).ctypes.data,
        np.ascontiguousarray(new_off, np.int64).ctypes.data,
        n, out.ctypes.data, out_len)
    if rc != 0:
        from ffmpeg_ht_tpu_torch.utils.errors import InvalidData
        raise InvalidData("segment gather out of bounds")
    return out


# ---------------------------------------------------------------------------
# Legacy EBCOT/MQ decoder (native/ebcot.c)
# ---------------------------------------------------------------------------

_EBCOT_BOUND = False


def ebcot_decode_cblk(data: bytes, npasses: int, nonzerobits: int,
                      cblk_style: int, width: int, height: int,
                      bandpos: int, magb: int, roi_shift: int,
                      nb_terminations: int, data_start,
                      log2_cblk_width: int):
    """Native MQ/EBCOT code-block decode; returns (h, w) int32.
    Raises InvalidData like the Python
    tier on malformed pass structure."""
    lib = load()
    global _EBCOT_BOUND
    if not _EBCOT_BOUND:
        lib.ebcot_decode_cblk.restype = ctypes.c_int
        lib.ebcot_decode_cblk.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        _EBCOT_BOUND = True
    stride = (1 << log2_cblk_width) + 2
    ds = np.ascontiguousarray(
        np.asarray(data_start if data_start is not None else [0],
                   np.int64))
    buf = np.frombuffer(bytes(data), np.uint8) if len(data) \
        else np.zeros(1, np.uint8)
    work = np.empty(stride * height + stride * (height + 2), np.uint32)
    out = np.empty((height, width), np.int32)
    rc = lib.ebcot_decode_cblk(
        buf.ctypes.data, len(data), npasses, nonzerobits, cblk_style,
        width, height, bandpos, magb, roi_shift, nb_terminations,
        ds.ctypes.data, len(ds), log2_cblk_width, 0,
        work.ctypes.data, out.ctypes.data)
    if rc < 0:
        from ffmpeg_ht_tpu_torch.utils.errors import InvalidData
        raise InvalidData("bpno became invalid" if rc == -1
                          else "Missing needed termination")
    if rc == 1:
        from ffmpeg_ht_tpu_torch.utils.log import logger
        logger.error("Segmentation symbol value incorrect")
    return out


# ---------------------------------------------------------------------------
# HT block decoder (native/htdec.c — C port of ops/ht_dec.py, the oracle)
# ---------------------------------------------------------------------------

_HTDEC_BOUND = False
_CXTVLC_FLAT = None


def ht_decode_block(buf, lcup: int, pcup: int, lref: int, pLSB: int,
                    width: int, height: int, maxbp: int, magb: int,
                    roi_shift: int, z_blk: int, is_causal: int):
    """Native HT code-block decode on the oracle's prepared buffer
    (extended + trailing 0xFF + modDcup, Scup already validated).
    Returns (h, w) int32 sign-magnitude samples, or None when the C
    decoder leaves its supported profile. Raises InvalidData exactly where the oracle does."""
    lib = load()
    global _HTDEC_BOUND, _CXTVLC_FLAT
    if not _HTDEC_BOUND:
        lib.ht_decode_block.restype = ctypes.c_int
        lib.ht_decode_block.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        from ffmpeg_ht_tpu_torch.ops import tables as tb
        _CXTVLC_FLAT = np.ascontiguousarray(
            tb.CXTVLC_PACKED.reshape(-1), np.uint16)
        _HTDEC_BOUND = True
    data = np.frombuffer(bytes(buf), np.uint8)
    out = np.empty((height, width), np.int32)
    rc = lib.ht_decode_block(
        data.ctypes.data, len(data), lcup, pcup, lref, pLSB,
        width, height, maxbp, magb, roi_shift, z_blk, is_causal,
        _CXTVLC_FLAT.ctypes.data, out.ctypes.data)
    if rc == -1:
        from ffmpeg_ht_tpu_torch.utils.errors import InvalidData
        raise InvalidData("bad U in HT cleanup")
    if rc != 0:
        return None
    return out
