"""ctypes loader for the frozen copy of the port's HT cleanup encoder.

A copy of ``ffmpeg_ht_tpu_torch/utils/native.py`` that keeps only what
``encode_frame_htj2k`` calls: the loader and ``ht_encode_cleanup``. The
one C source beside it, ``native/htenc.c``, is compiled with ``cc -O3
-shared -fPIC`` into ``build/htbench/libhtenc.so`` under the repository
root (to a temporary name, then renamed, so that concurrent processes
never load a half-written library), and rebuilt when the source is newer
than the library. A missing compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

import numpy as np


NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))), "build", "htbench")
LIB_PATH = os.path.join(BUILD_DIR, "libhtenc.so")
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
        _LIB = lib
        return _LIB


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
    from htbench.frozen.ops.ht_enc import (_inverse_cxtvlc,
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
