"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file exposes a plain C entry point (device pointers,
sizes, the CUDA stream; returns ``cudaGetLastError()``). At first use the
sources are compiled by ``nvcc`` for Hopper (``sm_90a``), one process per
source, all started together, and linked into one shared library,
``build/ffmpeg_ht_tpu_torch/libhtkernels.so`` under the repository root,
which is loaded with ``ctypes``. No PyTorch header is included, so a
build takes seconds rather than minutes. The library is rebuilt when any
source is newer than it; the build's nvcc output (ptxas registers and
shared memory) is kept beside it and loaded with it. A missing ``nvcc``
or a failed compile raises: there is no fallback. Each wrapper launches
inside ``torch.cuda.device`` of its tensors, on that device's current
stream: the entry points launch on the runtime's current device, so a
tensor on a second card would otherwise meet a stream of another device.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build",
                         "ffmpeg_ht_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libhtkernels.so")
LOG_PATH = LIB_PATH + ".log"         # the build's nvcc output
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64

# C signatures of the kernels' entry points (see csrc/*.cu)
_SIGNATURES = {
    "ht_vlc_pass_launch": [_P, _I, _P, _I,               # melw, vlcw
                           _P, _P, _P,                   # mel_lim, qws, qhs
                           _P, _I, _I, _I,               # tables, N, qw, qh
                           _P, _P],                      # rec, stream
    "ht_magsgn_pass_launch": [_P, _P, _I,                # rec, msw
                              _P, _P, _P, _P, _P,        # per-lane vectors
                              _I, _I, _I, _I,            # N, qw, qh, class
                              _P, _P, _P, _P],           # mu, sig, ok, stream
    "rct_writeframe_launch": [_P, _P, _P, _I64, _I64,    # y0..y2, h, w
                              _I, _P, _I64, _I,          # cbps, out, size,
                                                         # kind
                              _P, _P],                   # dests, stream
    "ict_writeframe_launch": [_P, _P, _P, _I,            # y0s..y2s, frames
                              _I64, _I64, _I,            # h, w, cbps
                              _P, _I64, _I64, _P,        # out, size,
                                                         # stride, dests
                              _I, _I, _P],               # kind, mode, stream
    "ht_sigprop_pass_launch": [_P, _P, _I,               # sig, spw
                               _P, _P,                   # has_sp, causal
                               _I, _I, _I, _I, _I,       # N, qw, qh, w, h
                               _P, _P],                  # words, stream
    "ht_magref_pass_launch": [_P, _P, _P, _I,            # mu, sig, mrw
                              _P, _P, _P,                # pLSB, has_mr, words
                              _I, _I, _I, _I, _I,        # N, qw, qh, w, h
                              _P, _P],                   # out, stream
    "wire_pack_launch": [_P, _I64, _I, _P, _P],          # in, n, depth,
                                                         # out, stream
    "coef_mosaic_launch": [_P, _P, _P, _P, _P, _P,       # mu, map, magb,
                                                         # istep, s97, fs
                           _I64, _I, _I, _I, _I,         # N, bh, bw, mode,
                                                         # no_istep
                           _P, _P, _I64, _P, _P],        # pf_idx, pf_val,
                                                         # n_pf, out, stream
    "dwt_lift_launch": [_P, _I, _P, _P,                  # table, jobs,
                                                         # in, out
                        _I, _I, _I, _I,                  # mode, tile rows,
                                                         # cols, halo pairs
                        _P, _P],                         # stream, launches
    "dwt_small_launch": [_P, _I, _I, _I,                 # table, planes,
                                                         # maxchain, smem
                         _P, _P, _I, _P],                # in, out, mode,
                                                         # stream
    "bucket_scatter_launch": [_P, _I,                    # buckets, n
                              _P, _P, _I64,              # pf_idx, pf_val, n
                              _I64, _I, _I,              # total, mode,
                                                         # no_istep
                              _P, _P, _P, _P],           # out, bits,
                                                         # stream, launches
    "plane_writeframe_launch": [_P, _I, _P, _I,          # table, n, base,
                                                         # float
                                _I, _P, _I64, _I,        # cbps, out, size,
                                                         # kind
                                _P, _P],                 # stream, launches
}


class KernelLibrary:
    """The loaded library plus how it was obtained."""

    def __init__(self, lib: ctypes.CDLL, build_seconds: float, log: str):
        self.lib = lib
        self.build_seconds = build_seconds   # 0.0 when the .so was fresh
        self.log = log                       # nvcc output (ptxas -v stats)
                                             # of the build that made it


_LOCK = threading.Lock()
_LOADED: "KernelLibrary | None" = None


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        if os.path.exists(cand):
            path = cand
    if path is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                           "kernels cannot be built")
    return path


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    deps = _sources() + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    return any(os.path.getmtime(s) > built for s in deps)


def _run(cmds):
    """Run the commands in parallel; raise on the first failure. Returns
    their joined output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    logs, failed = [], None
    for cmd, proc in procs:
        out = proc.communicate()[0]
        logs.append(out)
        if proc.returncode != 0 and failed is None:
            failed = "nvcc failed (exit %d):\n%s\n%s" % (
                proc.returncode, " ".join(cmd), out[-8000:])
    if failed:
        raise RuntimeError(failed)
    return "".join(logs)


def _compile() -> str:
    srcs = _sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    objs = [os.path.join(BUILD_DIR, "%s.%d.o" % (
        os.path.splitext(os.path.basename(s))[0], pid)) for s in srcs]
    tmp = f"{LIB_PATH}.{pid}.tmp"
    try:
        log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", o, s]
                    for s, o in zip(srcs, objs)])
        log += _run([[nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]])
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    with open(f"{LOG_PATH}.{pid}.tmp", "w") as f:
        f.write(log)
    os.replace(f"{LOG_PATH}.{pid}.tmp", LOG_PATH)
    os.replace(tmp, LIB_PATH)        # atomic: a concurrent loader never
    return log                       # sees a half-written library


def load() -> KernelLibrary:
    """Build (if stale) and load the kernel library; cached per process."""
    global _LOADED
    with _LOCK:
        if _LOADED is not None:
            return _LOADED
        t0 = time.perf_counter()
        rebuild = _stale()
        if rebuild:
            log = _compile()
        else:
            try:
                with open(LOG_PATH) as f:
                    log = f.read()
            except FileNotFoundError:
                log = ""
        secs = time.perf_counter() - t0 if rebuild else 0.0
        lib = ctypes.CDLL(LIB_PATH)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LOADED = KernelLibrary(lib, secs, log)
        return _LOADED


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
