#!/usr/bin/env python3
"""Profile the PyTorch port's device programs on one NVIDIA card.

    python3 tools/profile_torch_v3.py [--config c3|c2|c4] [--reps 5]
                                      [--trace trace.json]

``--config c3`` (the default) encodes the natural-content DCI-4K 10-bit
4:4:4 RCT frame of ``chip_smoke.py`` (same seed) and decodes it once
through ``Decoder(device="cuda")``; ``--config c2`` encodes the four
1080p 8-bit RGB 9/7 + ICT frames of ``chip_smoke.py`` phase 6 (same
seed) and decodes them once through ``Decoder(device="cuda",
bitexact=False).decode_batch``, one program of four frames; ``--config
c4`` encodes the two 2048x2048 10-bit gray refined frames of phase 7
(BASELINE config 4, cropped) and profiles the v2 ``BucketProgram`` that
``decode_batch`` runs on [A, B, A, B]. The tool builds the program; then:

  1. times `reps` calls of the program on lane arrays already on the
     card with CUDA events (wall ms per call, and per frame, no profiler
     attached);
  2. runs ``torch.profiler`` over another `reps` calls and prints, per
     program call: the device-busy ms (sum of the device-side spans:
     kernels, copies, fills), the device timeline's span from the first
     device operation to the last, the busy share of that span, the
     number of device operations, and the operations that take the most
     time;
  3. runs the program back to back for about 3 s while nvidia-smi
     samples the card's SM clock and power draw every 100 ms, and prints
     their median and maximum.

``--trace`` also writes the profile as a Chrome trace. Needs a card, and
neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import (ENC, H, W, _c2_streams, _c4_streams, _gpu_name_power,
                        _natural, _rgb)

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ffmpeg_ht_tpu_torch.codestream.parser import parse_codestream
from ffmpeg_ht_tpu_torch.models import fastpath as FP
from ffmpeg_ht_tpu_torch.models.assembly import BucketProgram
from ffmpeg_ht_tpu_torch.models.decoder import Decoder
from ffmpeg_ht_tpu_torch.models.encoder import encode_frame_htj2k
from ffmpeg_ht_tpu_torch.models.fastpath import finish_v3_numpy, to_torch


def _wall_ms(run, reps: int) -> float:
    """Mean ms per program call by CUDA events, after warm-up calls."""
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        run()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def _profile(run, frames: int, reps: int, trace):
    wall = _wall_ms(run, reps)
    print(f"program of {frames} frame(s): {wall / frames:.3f} "
          "ms/frame (CUDA events, no profiler)")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    dev = [e for e in p.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / reps
    span = (max(e.time_range.end for e in dev)
            - min(e.time_range.start for e in dev)) / 1e3 / reps
    print(f"{reps} programs: wall {wall:.3f} ms/program (CUDA events, no "
          f"profiler); profiled: device busy {busy:.3f} ms/program over a "
          f"device span of {span:.3f} ms/program ({100 * busy / span:.1f}% "
          f"busy), {len(dev) / reps:.0f} device ops/program")
    per = {}
    for e in dev:
        n, us = per.get(e.name, (0, 0.0))
        per[e.name] = (n + 1, us + e.time_range.elapsed_us())
    print("top device ops (ms/program, calls/program):")
    for name, (n, us) in sorted(per.items(), key=lambda kv: -kv[1][1])[:15]:
        print(f"  {us / 1e3 / reps:8.3f} ms  {n / reps:6.0f}  {name[:90]}")
    if trace:
        os.makedirs(os.path.dirname(os.path.abspath(trace)), exist_ok=True)
        p.export_chrome_trace(trace)
        print(f"trace -> {trace}")


def _clocks_power(run, seconds: float = 3.0):
    smi = subprocess.Popen(
        ["nvidia-smi", "-i", os.environ["CUDA_VISIBLE_DEVICES"],
         "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
         "-lms", "100"], stdout=subprocess.PIPE, text=True)
    try:
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            run()
    finally:
        smi.terminate()
        out = smi.communicate()[0]
        torch.cuda.synchronize()
    rows = [ln.split(",") for ln in out.strip().splitlines()]
    clk = [float(r[0]) for r in rows if len(r) == 2]
    pw = [float(r[1]) for r in rows if len(r) == 2]
    if not pw:
        raise RuntimeError(f"no nvidia-smi samples: {out!r}")
    print(f"under load ({len(pw)} samples over {seconds:.0f} s): SM clock "
          f"median {statistics.median(clk):.0f} MHz, max {max(clk):.0f}; "
          f"power median {statistics.median(pw):.1f} W, max {max(pw):.1f}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=("c3", "c2", "c4"), default="c3")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--trace", default=None)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_v3: no CUDA card", file=sys.stderr)
        return 1
    print(f"card: {_gpu_name_power()} | torch {torch.__version__} | "
          f"config {opts.config}")
    if opts.config == "c4":
        _srcs, (fa, fb) = _c4_streams()
        dec = Decoder(device="cuda")
        hdrs = [parse_codestream(d, bitexact=True) for d in (fa, fb, fa, fb)]
        fg = dec._fast_geom(hdrs[0])
        # the program decode_batch [A, B, A, B] dispatches
        gm, (shapes, bargs, pf_idx, pf_val), _accum = dec._v2_args(
            fg, [FP.parse_frame_flat(h, fg) for h in hdrs])
        prog = BucketProgram(shapes, gm.key())
        up = lambda v: to_torch(v, "cuda") if isinstance(v, np.ndarray) \
            else v
        args = (up(pf_idx), up(pf_val),
                [{k: up(v) for k, v in ba.items()} for ba in bargs])
        print(f"c4 [A, B, A, B]: {len(shapes)} buckets, "
              f"{sum(x['nreal'] for x in bargs)} device lanes")
        _profile(lambda: prog(*args), 4, opts.reps, opts.trace)
        _clocks_power(lambda: prog(*args))
        return 0
    if opts.config == "c3":
        streams = [encode_frame_htj2k(
            _rgb(_natural(np.random.default_rng(2024), H, W)), **ENC)]
        bitexact = True
    else:
        streams = _c2_streams(np.random.default_rng(2025))
        bitexact = False
    dec = Decoder(device="cuda", bitexact=bitexact)
    dec.decode_batch(streams)
    hdrs = [parse_codestream(d, bitexact=bitexact) for d in streams]
    fg = dec._fast_geom(hdrs[0])
    (prog,) = [p for k, p in fg.v3_progs.items() if k[0] == len(streams)]
    fcs = [FP.build_v3_frame(fg, FP.parse_frame_flat(h, fg)) for h in hdrs]
    args = {k: to_torch(v, "cuda") for k, v in
            finish_v3_numpy(fg, fcs, fg.geom.total)[0].items()}
    _profile(lambda: prog(**args), prog.frames, opts.reps, opts.trace)
    _clocks_power(lambda: prog(**args))
    return 0


if __name__ == "__main__":
    sys.exit(main())
