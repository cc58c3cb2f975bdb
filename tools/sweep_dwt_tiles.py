"""Sweep the tile height of the band-direct inverse DWT kernel on the card.

    python3 tools/sweep_dwt_tiles.py [--rows 8,16,24,32] [--reps 20]

Builds the kernels (``ffmpeg_ht_tpu_torch/csrc``) at first use, makes
random band buffers of two programs at their full size (c3: three
4096x2160 planes, 6 levels, 5/3; c2: twelve 1920x1080 planes, the four
frames of a batch, 5 levels, integer and float 9/7), and times the
kernel's C entry on every level of the program (CUDA events, calls
queued behind a spin) and on its top level alone, at each tile height
(``dwt_cuda.TILE_ROWS`` is the one the port uses; the kernel's 40-row
window holds at most 32 rows and the 9/7's halos), every output checked
by bits against ``dwt_lift_program``'s. Prints the card's name and power
limit, then one JSON line per (program, transform, tile height). Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import copy
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from ffmpeg_ht_tpu_torch.ops import dwt_cuda  # noqa: E402
from ffmpeg_ht_tpu_torch.ops.dwt import (DWT53, DWT97, DWT97_INT,  # noqa
                                         dwt_levels)
from ffmpeg_ht_tpu_torch.utils import build  # noqa: E402

PROGRAMS = {"c3": ([[[0, 4096], [0, 2160]]] * 3, 6, (DWT53,)),
            "c2": ([[[0, 1920], [0, 1080]]] * 12, 5, (DWT97_INT, DWT97))}


def program(borders, ndec, transform, rng, dev):
    """A LiftPlan over the planes of `borders` and a random band buffer
    laid out as a CoefLayout lays it out (LL, then HL, LH, HH a level)."""
    shapes, planes = [], []
    for b in borders:
        linelen, mod = dwt_levels(b, ndec)
        ll, lvls = None, []
        for lev in range(ndec):
            (lh, lv), (mh, mv) = linelen[lev], mod[lev]
            nlh, nlv = len(range(mh, lh, 2)), len(range(mv, lv, 2))
            if ll is None:
                ll = len(shapes)
                shapes.append((nlv, nlh))
            i = len(shapes)
            shapes += [(nlv, lh - nlh), (lv - nlv, nlh), (lv - nlv, lh - nlh)]
            lvls.append((i, i + 1, i + 2))
        planes.append((ll, lvls, mod[:ndec]))
    offs = np.cumsum([0] + [h * w for h, w in shapes])[:-1]
    plan = dwt_cuda.LiftPlan([int(o) for o in offs], shapes, planes,
                             transform)
    dt = torch.float32 if transform == DWT97 else torch.int32
    bands = torch.from_numpy(rng.integers(-4000, 4000, plan.band_total,
                                          dtype=np.int32)).to(dt).to(dev)
    return plan, bands


def launch(plan, bands, out, rows):
    """The kernel's C entry on every job of `plan` at `rows`-row tiles."""
    t, n = plan.transform, ctypes.c_int(0)
    err = build.load().lib.dwt_lift_launch(
        plan.table.ctypes.data, len(plan.table), bands.data_ptr(),
        out.data_ptr(), dwt_cuda._MODE[t], rows, dwt_cuda.tile_cols(t),
        dwt_cuda.HALO_PAIRS[t], torch.cuda.current_stream().cuda_stream,
        ctypes.addressof(n))
    build.check(err, "dwt_lift_launch")


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", default="8,16,24,32")
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    rows = [int(r) for r in a.rows.split(",")]
    for name, (borders, ndec, transforms) in PROGRAMS.items():
        for t in transforms:
            plan, bands = program(borders, ndec, t, np.random.default_rng(1),
                                  dev)
            top = [j for j, (_i, lev, _w, _h) in enumerate(plan.jobs)
                   if lev == ndec - 1]
            # the top level alone at the full call's places (timing only:
            # its LL is read from a scratch buffer of the full call's size)
            top_plan = copy.copy(plan)
            top_plan.table = plan.table[top]
            want = dwt_cuda.dwt_lift_program(plan, bands).view(torch.int32)
            out = torch.empty(plan.total, dtype=bands.dtype, device=dev)
            for r in rows:
                out.zero_()
                launch(plan, bands, out, r)
                same = torch.equal(out.view(torch.int32), want)
                chain = cuda_ms(lambda: launch(plan, bands, out, r), a.reps)
                top_ms = cuda_ms(lambda: launch(top_plan, bands, out, r),
                                 a.reps)
                samples = sum(w * h for _i, _l, w, h in plan.jobs)
                print(json.dumps(dict(
                    program=name, transform=t, tile_rows=r,
                    tile_cols=dwt_cuda.tile_cols(t), chain_ms=chain,
                    top_level_ms=top_ms, samples=samples,
                    same_bits_as_program=bool(same))), flush=True)


if __name__ == "__main__":
    main()
