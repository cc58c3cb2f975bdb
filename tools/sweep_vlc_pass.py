#!/usr/bin/env python3
"""Time the HT cleanup's VLC pass at several codeblocks per warp.

    python3 tools/sweep_vlc_pass.py [--kpw 32 16 8 4 2 1] [--reps 20]

``csrc/ht_vlc_pass.cu`` runs one codeblock per thread on the first KPW
lanes of each warp (4 warps per block). This tool builds the kernel once
per KPW value (``nvcc -DKPW=k``, into build/ffmpeg_ht_tpu_torch/sweep/),
runs each build on the lanes of ``chip_smoke.py``'s natural-content
DCI-4K 10-bit 4:4:4 frame (same seed), checks that its records equal the
default build's, and prints the mean ms per launch by CUDA events, the
builds timed in turns (forward, then backward). Needs a card, and
neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import ENC, H, W, _gpu_name_power, _natural, _rgb

import numpy as np
import torch

from ffmpeg_ht_tpu_torch.codestream.parser import parse_codestream
from ffmpeg_ht_tpu_torch.models import fastpath as FP
from ffmpeg_ht_tpu_torch.models.encoder import encode_frame_htj2k
from ffmpeg_ht_tpu_torch.models.fastpath import finish_v3_numpy, to_torch
from ffmpeg_ht_tpu_torch.ops import ht_scan
from ffmpeg_ht_tpu_torch.utils import build


def _build(kpw: int):
    """The VLC pass compiled with -DKPW=kpw: (ctypes library, ptxas line)."""
    out_dir = os.path.join(build.BUILD_DIR, "sweep")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"libvlc_kpw{kpw}.so")
    src = os.path.join(build.CSRC_DIR, "ht_vlc_pass.cu")
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, f"-DKPW={kpw}",
                          "-o", out, src], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc -DKPW={kpw} failed:\n{res.stderr[-4000:]}")
    lib = ctypes.CDLL(out)
    fn = lib.ht_vlc_pass_launch
    fn.argtypes = build._SIGNATURES["ht_vlc_pass_launch"]
    fn.restype = ctypes.c_int
    regs = [ln.split(":", 1)[-1].strip() for ln in res.stderr.splitlines()
            if "registers" in ln]
    return fn, (regs[0] if regs else "")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kpw", type=int, nargs="+",
                    default=[32, 16, 8, 4, 2, 1])
    ap.add_argument("--reps", type=int, default=20)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_vlc_pass: no CUDA card", file=sys.stderr)
        return 1
    print(f"card: {_gpu_name_power()} | torch {torch.__version__}")
    data = encode_frame_htj2k(
        _rgb(_natural(np.random.default_rng(2024), H, W)), **ENC)
    hdr = parse_codestream(data, bitexact=True)
    fg = FP.FlatGeometry(hdr)
    fc = FP.build_v3_frame(fg, FP.parse_frame_flat(hdr, fg))
    a = {k: to_torch(v, "cuda") for k, v in
         finish_v3_numpy(fg, [fc], fg.geom.total)[0].items()}
    qh, qw = (d // 2 for d in FP.lane_raster_dims(fg))
    vlc_in = (a["melw"], a["vlcw"], a["mel_lim"], a["qws"], a["qhs"], qw, qh)
    want = ht_scan.ht_vlc_pass(*vlc_in)
    N = want.shape[0]
    tables = ht_scan._device_tables(want.device)
    rec = torch.empty_like(want)

    def launch(fn):
        err = fn(a["melw"].data_ptr(), a["melw"].shape[1],
                 a["vlcw"].data_ptr(), a["vlcw"].shape[1],
                 a["mel_lim"].data_ptr(), a["qws"].data_ptr(),
                 a["qhs"].data_ptr(), tables.data_ptr(), N, qw, qh,
                 rec.data_ptr(), torch.cuda.current_stream().cuda_stream)
        build.check(err, "ht_vlc_pass_launch")

    fns = {}
    for k in opts.kpw:
        fn, regs = _build(k)
        rec.zero_()
        launch(fn)
        torch.cuda.synchronize()
        if not torch.equal(rec, want):
            raise RuntimeError(f"KPW={k}: records differ from the default "
                               "build's")
        fns[k] = fn
        print(f"KPW={k}: records == default build on {N} lanes; {regs}")
    times = {k: [] for k in opts.kpw}
    for k in opts.kpw + opts.kpw[::-1]:
        launch(fns[k])
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(opts.reps):
            launch(fns[k])
        t1.record()
        t1.synchronize()
        times[k].append(t0.elapsed_time(t1) / opts.reps)
    for k in opts.kpw:
        warps = -(-N // k)
        print(f"KPW={k:2d}: {warps} warps in {-(-warps // 4)} blocks; ms "
              + ", ".join(f"{t:.4f}" for t in times[k]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
