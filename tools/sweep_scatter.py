"""Sweep the lane pass of ``bucket_scatter`` on the card.

    python3 tools/sweep_scatter.py [--variants 4x4,2x8] [--reps 20]

Builds ``ffmpeg_ht_tpu_torch/csrc/bucket_scatter.cu`` alone with nvcc (the
port's flags) once for each variant UxB, ``-DSCATTER_UNROLL=U
-DSCATTER_MIN_BLOCKS=B`` (the row groups of a warp task, the blocks an SM
must hold), all builds at once, into ``build/sweep_scatter/``. Lays out a
c4-sized flat buffer: 16 planes of 1024x1024, 6 decomposition levels, every
band cut into 64x64 codeblocks (32x32 and 16x16 at the two lowest levels),
each codeblock a lane of its bucket, the lane counts padded to a power of
two with pad lanes, random mu words and a few prefill entries (5/3). Times
each build's C entry (CUDA events, calls queued behind a spin), every
output checked by bits against ``bucket_scatter_ref``. Prints the card's
name and power limit, then one JSON line per variant (ptxas registers, ms,
share of the byte bound). Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ffmpeg_ht_tpu_torch.ops import coef_cuda  # noqa: E402
from ffmpeg_ht_tpu_torch.ops.dwt import DWT53  # noqa: E402
from ffmpeg_ht_tpu_torch.utils import build  # noqa: E402

OUT = os.path.join(ROOT, "build", "sweep_scatter")
SRC = os.path.join(build.CSRC_DIR, "bucket_scatter.cu")
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, published, at the 700 W limit


def compile_all(variants):
    """{variant: (the loaded library, ptxas lines)}, built in parallel."""
    os.makedirs(OUT, exist_ok=True)
    nvcc = build._nvcc()
    procs = {}
    for u, b in variants:
        so = os.path.join(OUT, f"libscatter_{u}x{b}.so")
        procs[u, b] = (so, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-shared", f"-DSCATTER_UNROLL={u}",
             f"-DSCATTER_MIN_BLOCKS={b}", "-I", build.CSRC_DIR, "-o", so,
             SRC], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for v, (so, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {v}:\n{log}")
        lib = ctypes.CDLL(so)
        fn = lib.bucket_scatter_launch
        fn.argtypes = build._SIGNATURES["bucket_scatter_launch"]
        fn.restype = ctypes.c_int
        regs = [ln.split("Used", 1)[1].strip() for ln in log.splitlines()
                if "Used" in ln]
        names = re.findall(r"entry function '([^']+)'", log)
        libs[v] = (fn, dict(zip(names, regs)))
    return libs


def c4_layout(rng, dev):
    """(bucket_scatter's args for mode 0, the real samples): 16 planes of
    1024x1024 as a c4 batch's flat buffer holds them."""
    planes, size = 16, 1024
    blocks = {}                     # (w, h) -> [(dest, stride)]
    for p in range(planes):
        base = p * size * size
        s = size // 2
        for _lev in range(6):
            cb = min(64, s)
            for y0, x0 in ((0, s), (s, 0), (s, s)):
                for by in range(0, s, cb):
                    for bx in range(0, s, cb):
                        blocks.setdefault((cb, cb), []).append(
                            (base + (y0 + by) * size + x0 + bx, size))
            s //= 2
        blocks.setdefault((2 * s, 2 * s), []).append((base, size))  # LL
    mus, dims, lanes, samples = [], [], [], 0
    for (w, h), cbs in sorted(blocks.items()):
        n = 1 << (len(cbs) - 1).bit_length()
        dest = np.full(n, -1, np.int32)
        stride = np.zeros(n, np.int32)
        dest[:len(cbs)] = [d for d, _s in cbs]
        stride[:len(cbs)] = [s for _d, s in cbs]
        samples += len(cbs) * w * h
        t = lambda a: torch.from_numpy(a).to(dev)
        mus.append(t(rng.integers(-2 ** 31, 2 ** 31, (n, h, w),
                                  dtype=np.int64).astype(np.int32)))
        dims.append((w, h))
        lanes.append(dict(dest=t(dest), stride=t(stride),
                          magb=t(np.full(n, 12, np.int32)),
                          istep=t(np.full(n, 32768, np.int32)),
                          scale97=t(np.zeros(n, np.int32)),
                          fscale=t(np.zeros(n, np.float32))))
    total = planes * size * size
    idx = np.unique(rng.choice(total, 64, replace=False)).astype(np.int32)
    pf_idx = torch.from_numpy(idx).to(dev)
    pf_val = torch.from_numpy(rng.integers(-999, 999, len(idx))
                              .astype(np.int32)).to(dev)
    return (mus, dims, lanes, pf_idx, pf_val, total), samples


def call(fn, table, args, out, bits):
    _mus, _dims, _lanes, pf_idx, pf_val, total = args
    n = ctypes.c_int(0)
    err = fn(table.ctypes.data, len(table), pf_idx.data_ptr(),
             pf_val.data_ptr(), pf_idx.shape[0], total, 0, 0,
             out.data_ptr(), bits.data_ptr(),
             torch.cuda.current_stream().cuda_stream, ctypes.addressof(n))
    build.check(err, "bucket_scatter_launch")


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4e5 * reps))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="4x4,4x2,4x3,2x4,2x6,2x8,8x2,8x3")
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
          .splitlines()[0])
    variants = [tuple(int(x) for x in v.split("x"))
                for v in a.variants.split(",")]
    libs = compile_all(variants)
    dev = torch.device("cuda", 0)
    args, samples = c4_layout(np.random.default_rng(15), dev)
    mus, dims, lanes, pf_idx, pf_val, total = args
    plan = coef_cuda.ScatterPlan([tuple(m.shape[1:]) for m in mus], dims)
    table = plan.fill(mus, lanes, dev)
    want = coef_cuda.bucket_scatter_ref(*args, DWT53, False)
    lanes_n = sum(int((ln["dest"] >= 0).sum()) for ln in lanes)
    # the real samples' mu read, the flat buffer written, the prefill and
    # the real lanes' six vectors read (PERF.md's count)
    bound = (4 * samples + 4 * (total + 1) + 8 * pf_idx.numel()
             + 24 * lanes_n) / HBM_BYTES_PER_S * 1e3
    mode = lambda name: re.search(r"ILi(\d)E", name).group(1)
    for v, (fn, regs) in libs.items():
        out = torch.empty(total + 1, dtype=torch.int32, device=dev)
        bits = torch.empty((total + 32) // 32, dtype=torch.int32, device=dev)
        call(fn, table, args, out, bits)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise RuntimeError(f"variant {v} differs from bucket_scatter_ref")
        ms = cuda_ms(lambda: call(fn, table, args, out, bits), a.reps)
        print(json.dumps(dict(
            unroll=v[0], min_blocks=v[1], ms=ms, bound_ms=bound,
            share=bound / ms, samples=samples, buckets=len(mus),
            ptxas={f"mode {mode(k)}": r for k, r in regs.items()
                   if "scatter_lanes" in k})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
