#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``ffmpeg_ht_tpu_torch`` end to end at three configurations of
BASELINE.json: config 3, three seeded DCI-4K (4096x2160) 10-bit 4:4:4
lossless frames (reversible 5/3 + RCT, 64x64 codeblocks, one 4096x4096
tile) through ``Decoder(device="cuda").decode_stream``; config 2,
four 1920x1080 8-bit RGB lossy frames (9/7 + ICT, 64x64 codeblocks, one
2048x2048 tile, 6 resolution levels, bench.py:345-355) through
``Decoder(device="cuda", bitexact=False).decode_batch`` and
``Decoder(device="cuda", bitexact=True).decode_stream``; and config 4
(bench.py:418-447), 10-bit gray lossless with 1024x1024 tiles, 64x64
codeblocks and precincts and two HT quality layers, cut from 7680x4320
to a 2048x2048 crop, through the v2 bucketed path; and config 5
(bench.py:451-480), four DCI-4K frames of config 3 muxed into an MXF,
through ``Decoder(device="cuda", bitexact=True, wire_pack=True)`` and the
CLI. Phases, one line or more each; any failure raises and the script
exits non-zero:

  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ffmpeg_ht_tpu_torch/csrc and the port's
     native host tier from ffmpeg_ht_tpu_torch/native;
  3. encode the three c3 frames with the port's encoder (natural
     value-noise, smooth, uniform random);
  4. each kernel against its plain PyTorch version on the card, on the
     first c3 frame's real lanes and planes: the HT cleanup's VLC pass
     (records exact), its MagSgn pass (on the same records) and the pair
     against ``cleanup_ref``, then RCT written where the decoder's
     program writes it (the rgb48le frame: R, G, B interleaved, << 6);
     each with its time by CUDA events, its bound from the bytes these
     inputs need, and the share of the bound;
  5. the c3 main path: launch counts reset, three frames decoded, counts
     read; every frame must equal its source in the negotiated pixel
     format (rgb48le, samples << 6), the cleanup kernels, RCT and
     ``coef_mosaic`` must have launched once per frame and ``dwt_lift``
     once per DWT level of a frame, and all frames must have gone
     through the v3 device program; then the median ms per frame over a
     few repetitions;
  6. the c2 irreversible path: the four frames encoded with the port's
     encoder (two seeded natural, two smooth); from the very program and
     lane arguments ``decode_batch`` runs (``Decoder._v3_program``, in
     the decoder's frame layout: rgb24 interleaved), ICT against its
     plain version in both modes on the frames' planes after the inverse
     DWT, written where that program writes them, all four in one launch
     and one frame alone (time, bound, share), and the HT cleanup
     kernels against their plain
     versions on the batch's lanes, as in phase 4; the main path
     ``decode_batch`` (float 9/7):
     counts reset, one launch of each kernel for the batch, counts read,
     every frame within 1 LSB of the host float oracle; the integer path
     ``decode_stream`` byte-equal to the host integer oracle with every
     frame on the device; a small stream whose lowest DWT level is below
     8x8 (flat fallback) byte-equal to the host oracle; then
     ``decode_batch`` ms per frame and ``bench_resident`` ms per frame;
  7. the c4 crop: two grainy natural frames encoded with the port's
     encoder (~90 s), their z_blk histograms (at least half of the device
     lanes must be refined); on every bucket of the v2 program that
     ``decode_batch`` [A, B, A, B] dispatches (``Decoder._v2_args``) the
     cleanup kernels against their plain versions and, on the refined
     buckets, the refinement kernels (``ht_sigprop_pass``, then
     ``ht_magref_pass``) each against its plain half and the pair
     against ``refine_ref`` (time, bound and share, summed and by
     bucket, beside the earlier kernel's time; their ptxas registers);
     the main paths ``decode_stream`` [A, B] and ``decode_batch`` [A, B,
     A, B] (counts reset before and read after each, every frame equal
     to its source, all on the v2 path); their ms per frame and one
     batch step by step; then 256x256 streams through the v2 path: RGB
     10-bit RCT (== source), RGB 8-bit 9/7 + ICT (integer == host
     oracle, float within 1 LSB), vertically stripe-causal (the object
     path, == source), ``max_layers=1`` and ``reduction_factor=1``
     (== the host oracle with the same option); then ``decode_batch``
     [A, B, A, B] once more with ``wire_pack=True`` (as bench.py's c4:
     every frame == source, one wire_pack launch at the end of the
     BucketProgram) and the batch's fetch and unpack ms with and without
     the pack; the main paths' launches of ``bucket_scatter``,
     ``dwt_lift`` and ``plane_writeframe`` as the BucketProgram's
     ``kernel_launches()`` says;
  8. config 5: phase 3's natural frame and its rolls by 3, 7 and 11
     columns (three more encodes) muxed with ``mux_mxf`` into
     build/c5_motion_htj2k.mxf; ``demux_mxf`` must give back the four
     codestreams exactly; ``decode_batch`` (one F=4 program) and
     ``decode_stream`` with ``wire_pack=True`` (counts reset before and
     read after each: one wire_pack launch a batch, one a frame), every
     frame equal to its source, and ``wire_pack=False`` giving the same
     bytes; the wire_pack kernel against ``pack_words_ref`` on the
     batch's own int16 output, and on runs of its samples at the sizes
     of one c5 frame and of the c4 batch, timed on consecutive runs in
     turn so that L2 holds no input between launches (time, bound,
     share at each, beside a ``copy_`` of the same input as a yardstick
     of the card's streaming rate; its ptxas registers and shared
     memory); fetch and unpack ms with and without the pack, ``decode_batch`` ms/frame both ways,
     ``bench_resident`` ms/frame at F=4; the CLI's ``decode -f framemd5
     --benchmark --device cuda`` on the MXF, whose framemd5 must equal
     that of the source frames (its ``bench:`` lines printed);
  9. ``decode_batch(devices=...)``: phase 8's four streams sharded over
     the card listed 2 and 3 times (F = 4 over D = 3: two pad frames),
     with and without the pack, ``require_shard=True`` (counts reset
     before and read after each: the cleanup pair and the pack once a
     shard, RCT once a frame of each shard, pads included), every frame
     byte-equal to phase 8's single program and to its source, ms per
     frame beside phase 8's single-device median (one card: no scaling);
     the cleanup kernels and RCT against their plain versions on shard
     0's own program and lanes (``Decoder._shard_plan`` /
     ``_v3_shard``); phase 7's refined c4 streams raise
     ``UnshardableBatch`` with ``require_shard``, and without it log
     "cannot shard" and decode equal to their sources;
 10. the conformance corpus (a copy of tests/test_torch_conformance.py's,
     which pins it; the FATE goldens are read from tests/ref): 36 small
     streams, the 10 FATE codestreams and the device-path streams of the
     conformance tests (PPT / PPM, POC, precincts, RPCL, placeholder
     passes, lowres, signed samples, ROI, ``ht_mixed``, ``max_layers``,
     RCT, ICT both ways, the wire pack), each through its own
     ``Decoder(device="cuda")``: counts reset, the corpus decoded, counts
     read; every frame equal to the host oracle (float 9/7 within 1 LSB),
     its golden framecrc or its source; every stream on its expected
     route with its expected launches; then, on every device stream's
     lanes, the cleanup kernels and on every refined bucket the
     refinement kernels against their plain versions, and RCT, ICT and
     the wire pack on their streams; ``decode_batch`` of three frames of
     one geometry (one V3Program with inert lanes) equal to the single
     decodes; 128 bit-flip mutants of two streams, each giving the host
     oracle's pixels or ``J2KError`` as the host oracle does, and
     ``torch.cuda.synchronize()`` after them. ``--only conformance`` runs
     phases 1, 2 and 10 alone (for a run under ``compute-sanitizer``);
 11. the v3 program's coefficient stages: on the programs and lanes of
     c3's natural frame (5/3) and of the c2 batch (integer and float
     9/7), ``coef_mosaic`` (dequant + prefill + band mosaic) against
     ``coef_mosaic_ref`` and the program's one ``dwt_lift_program`` call
     (and ``dwt_lift`` level by level) against ``dwt_level_ref`` at
     every level (by bits, so float 9/7 too), each with its time by CUDA
     events, its bound and share (``dwt_lift`` also by level, its
     launches a call and its wrapper's host ms); the V3Program's ms per
     frame, device operations and device-busy ms with the kernels and
     with the plain torch stages forced on the card (the "before", for
     the record);
 12. the v2 program and the flat fallback on their kernels, at config
     4's widths (1024x1024 tiles, 64x64 codeblocks and precincts, 7
     resolution levels, 10-bit): on phase 7's decode_batch [A, B, A, B]
     BucketProgram (16 planes of 1024x1024) and on a 1536x1248 crop of
     the 8K frame's extent holding its four tile shapes (1024x1024,
     512x1024, 1024x224 and 512x224, whose lowest DWT levels are 32x7 and
     16x7), encoded layered (a BucketProgram) and single-layer (a
     V3Program with levels under 8x8): ``bucket_scatter`` (dequant +
     prefill + scatter of every bucket) or ``coef_mosaic``, the program's
     one ``dwt_lift_program`` call (``dwt_small`` for the levels under
     8x8, strided ``dwt_lift`` jobs on the flat buffer) and
     ``plane_writeframe`` (DC shift + clip + pack of every plane without
     MCT) against their plain versions by bits, each with its time by
     CUDA events, bound, share, launches a call and ptxas registers
     (``bucket_scatter`` beside an ``index_put_`` of its values, with its
     wrapper's host ms; ``dwt_small`` with the jobs that took each
     storage and a latency bound beside its byte bound); each program's
     ms/frame, device operations and device-busy ms with the kernels and
     with the plain stages forced (the c4 batch program's operations must
     fall twentyfold from the 2395 of its torch stages, to at most 40);
     the crop's two streams through ``Decoder.decode`` (counts reset
     before and read after, == source). ``--only programs`` runs phases
     1, 2 and 12 alone.
     Phases 4-10 run every program through these kernels: the launch
     counts of phases 5-10 include them (phase 10's corpus stream by
     stream), and phase 10 checks each against its plain version on
     every device stream of the corpus.

The last lines are the card's name and power limit, a JSON object with
the per-kernel numbers and ``{"ok": true, "device": {...}}``. Needs no
network, no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import io
import itertools
import json
import logging
import os
import re
import statistics
import subprocess
import sys
import time

# the run uses one card: keep only the first visible one, before torch
# initialises CUDA, so device 0 and device_count() both mean that card
os.environ["CUDA_VISIBLE_DEVICES"] = \
    os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]

import numpy as np
import torch

from ffmpeg_ht_tpu_torch import cli
from ffmpeg_ht_tpu_torch.codestream.parser import parse_codestream
from ffmpeg_ht_tpu_torch.containers import mux
from ffmpeg_ht_tpu_torch.containers.mxf import demux_mxf, mux_mxf
from ffmpeg_ht_tpu_torch.models import assembly as ASM
from ffmpeg_ht_tpu_torch.models import decoder as DEC
from ffmpeg_ht_tpu_torch.models import fastpath as FP
from ffmpeg_ht_tpu_torch.models import host_decoder
from ffmpeg_ht_tpu_torch.models.assembly import V3Program
from ffmpeg_ht_tpu_torch.models.decoder import Decoder
from ffmpeg_ht_tpu_torch.models.encoder import (encode_frame_htj2k,
                                                encode_frame_t800)
from ffmpeg_ht_tpu_torch.models.fastpath import finish_v3_numpy, to_torch
from ffmpeg_ht_tpu_torch.ops import (coef_cuda, dwt_cuda, dwt_torch,
                                     ht_refine, ht_scan, mct_cuda, wirepack)
from ffmpeg_ht_tpu_torch.ops.dwt import DWT53, DWT97, DWT97_INT
from ffmpeg_ht_tpu_torch.utils import build, native
from ffmpeg_ht_tpu_torch.utils.errors import J2KError, UnshardableBatch

W, H, DEPTH = 4096, 2160, 10
ENC = dict(depth=DEPTH, tile_width=4096, tile_height=4096,
           log2_cblk_width=6, log2_cblk_height=6, mct=True)
REPS = 3
# BASELINE config 2 (bench.py:345-355): 1080p 8-bit RGB, 9/7 + ICT
C2_W, C2_H = 1920, 1080
C2_ENC = dict(pred=0, mct=True, tile_width=2048, tile_height=2048,
              log2_cblk_width=6, log2_cblk_height=6, nreslevels=6)
# BASELINE config 4 (bench.py:418-447): 8K tiled 10-bit gray lossless,
# 1024x1024 tiles, 64x64 codeblocks and precincts, two HT quality layers;
# here a 2048x2048 crop (4 of the frame's 40 tiles) of natural content
C4_W = C4_H = 2048
C4_ENC = dict(depth=10, tile_width=1024, tile_height=1024,
              log2_cblk_width=6, log2_cblk_height=6, log2_prec_width=6,
              refinement=True, ht_layers=2)
# the small streams of phase 7 (256x256, 32x32 codeblocks, 4 levels)
SMALL_ENC = dict(log2_cblk_width=5, log2_cblk_height=5, nreslevels=4,
                 refinement=True, ht_layers=2)
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, published, at the 700 W limit
# dwt_small's latency bound: a plane's small levels are one chain of
# dependent lifting steps, each at least one round trip through shared
# memory (a store, a barrier, a load), after one load of the bands from
# device memory and before one store of the outputs. The costs in SM
# cycles are assumed (not measured here), at the card's maximum SM clock
SMEM_ROUND_TRIP_CYCLES = 64
DEVICE_LOAD_CYCLES = 600
DEVICE_STORE_CYCLES = 600
# BASELINE config 5 (bench.py:451-480): phase 3's natural frame and its
# rolls by these columns, muxed into an MXF
C5_ROLLS = (3, 7, 11)
BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
# the earlier cleanup kernel, one thread per codeblock, on an H100 80GB
# HBM3 at 700 W (PERF.md, section 6): printed beside the split design
ONE_THREAD_CLEANUP_MS = 2.46
# the earlier refinement kernel, one warp per codeblock with SigProp on
# lane 0, on the six refined buckets of the c4 decode_batch [A, B, A, B]
# program, summed; H100 80GB HBM3 at 700 W (PERF.md, section 6)
ONE_WARP_REFINE_MS = 1.0664
# the earlier wire pack kernel, one thread per 32-sample group, on the c5
# batch; H100 80GB HBM3 at 700 W (PERF.md, section 6)
ONE_THREAD_WIRE_PACK_MS = 0.3641


def _natural(rng, h, w, maxval=1023, dtype=np.uint16):
    """Mixed-frequency value noise (octaves at 8/32/128/512 px) scaled to
    [0, maxval] (10-bit by default)."""
    acc = np.zeros((h, w))
    for period, amp in ((8, 0.5), (32, 0.25), (128, 0.15), (512, 0.1)):
        g = rng.standard_normal((h // period + 2, w // period + 2))
        yi, xi = np.arange(h) / period, np.arange(w) / period
        y0, x0 = yi.astype(int), xi.astype(int)
        fy, fx = (yi - y0)[:, None], (xi - x0)[None, :]
        a, b = g[y0][:, x0], g[y0][:, x0 + 1]
        c, d = g[y0 + 1][:, x0], g[y0 + 1][:, x0 + 1]
        acc += amp * ((a * (1 - fx) + b * fx) * (1 - fy)
                      + (c * (1 - fx) + d * fx) * fy)
    acc = (acc - acc.min()) / (np.ptp(acc) + 1e-9)
    return (acc * maxval).astype(dtype)


def _grainy(rng, h, w):
    """10-bit natural value noise with Gaussian sensor grain (sigma 2
    LSB): a camera frame's fine detail, whose small coefficients are what
    the HT refinement passes carry (smooth content leaves isolated +-1
    coefficients that SigProp cannot reach, and the encoder codes such a
    codeblock with the cleanup pass alone)."""
    base = _natural(rng, h, w).astype(np.float64) * 0.9 + 51
    return np.clip(np.rint(base + rng.normal(0, 2, (h, w))), 0,
                   1023).astype(np.uint16)


def _smooth(h, w, maxval=1023, dtype=np.uint16):
    base = np.sin(np.linspace(0, 7, h)[:, None]) \
        * np.cos(np.linspace(0, 11, w)[None, :])
    return (((base + 1) / 2) * maxval).astype(dtype)


def _rgb(plane):
    return np.stack([plane, np.roll(plane, 5, 1), np.roll(plane, 9, 0)], 2)


def _gpu_name_power() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "-i", os.environ["CUDA_VISIBLE_DEVICES"],
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _bound(nbytes) -> float:
    """ms to move `nbytes` at the card's memory rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def _max_sm_mhz() -> float:
    """The card's maximum SM clock, MHz, as nvidia-smi reports it."""
    return float(subprocess.run(
        ["nvidia-smi", "-i", os.environ["CUDA_VISIBLE_DEVICES"],
         "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])


def _small_latency_bound(plan) -> float:
    """dwt_small's latency bound, ms, for `plan`'s small jobs: the longest
    plane chain of lifting steps (a transform's steps on rows and on
    columns a level, one for a line of one sample) at
    SMEM_ROUND_TRIP_CYCLES each, plus one device load and one store."""
    steps = 2 if plan.transform == DWT53 else 4
    chains = [sum((steps if w > 1 else 1) + (steps if h > 1 else 1)
                  for w, h in plan.small_table[lo:hi, 7:9].tolist())
              for lo, hi in zip(plan.small_chains[:-1].tolist(),
                                plan.small_chains[1:].tolist())]
    cycles = max(chains) * SMEM_ROUND_TRIP_CYCLES + DEVICE_LOAD_CYCLES \
        + DEVICE_STORE_CYCLES
    return cycles / (_max_sm_mhz() * 1e3)


def _cuda_ms(fn, reps: int, head_start: bool = False) -> float:
    """Mean device ms per call of fn() over `reps` calls (CUDA events,
    after one warm-up call). With `head_start`, the stream first spins
    for ~0.2 ms per call, so that the host has queued every call before
    the first one runs: the events then time back-to-back kernels, not
    the wrapper's host work between two short launches."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    if head_start:
        torch.cuda._sleep(int(4e5 * reps))     # ~2 GHz cycles
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def _laps(dec, streams, bitexact: bool, dev):
    """Where a batch's time goes: the calls Decoder.decode_batch makes for
    `streams`, timed one by one with a device sync after each device step
    (host clock, ms for the whole batch)."""
    hdrs = [parse_codestream(d, bitexact=bitexact) for d in streams]
    fg = dec._fast_geom(hdrs[0])
    # the decoder's own program: (F, ms_class, no_istep, layout)
    layout = dec._layout(hdrs, fg.geom)
    (prog,) = [p for (F, _c, _i, lay), p in fg.v3_progs.items()
               if F == len(streams) and lay == layout]
    stage = FP.Staging(dev)
    laps, val = {}, None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for name, step in (
            ("parse", lambda _: [parse_codestream(d, bitexact=bitexact)
                                 for d in streams]),
            ("t2_native", lambda _: [FP.parse_frame_flat(h, fg)
                                     for h in hdrs]),
            ("build_v3_frame", lambda cols: [FP.build_v3_frame(fg, c)
                                             for c in cols]),
            ("stream_prep", lambda fcs: finish_v3_numpy(
                fg, fcs, fg.geom.total, stage.alloc)[1]),
            ("upload", lambda F: stage.views(to_torch(stage.host, dev), F)),
            ("device_program", lambda a: prog(**a)),
            ("fetch", lambda p: (p.cpu(), layout)),
            ("write_frame", lambda p: dec._split_frames(
                [(h, fg.tiles) for h in hdrs], fg.geom, p))):
        val = step(val)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        laps[name] = (t1 - t0) * 1e3
        t0 = t1
    total = sum(laps.values())
    return (" | ".join(f"{k} {v:.1f}" for k, v in laps.items())
            + f" | total {total:.1f}; device program "
            f"{100 * laps['device_program'] / total:.1f}% of it")


def _v3_segments(fcs):
    """(lcup, pcup) of the decoded lanes of v3 frame columns `fcs`."""
    return (np.concatenate([fc["lcups"][fc["qws"] > 0] for fc in fcs]),
            np.concatenate([fc["pcups"][fc["qws"] > 0] for fc in fcs]))


def _plain(fn, *a):
    """(fn(*a), its ms on the host clock, synchronised before and after)."""
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = fn(*a)
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t1) * 1e3


def _host_ms(fn, reps: int) -> float:
    """Host ms of one fn() call: `reps` calls queued behind a spin of the
    stream (~1 ms a call), so that none waits on the card."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e6 * reps))
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def _ptxas(log, names):
    """{kernel: what ptxas -v says it uses (registers, shared memory)} for
    the entry functions whose mangled name holds one of `names`; a template
    instance keeps its argument (``ht_magref_kernel<2>``)."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"entry function '([^']+)'", ln)
        if m:
            cur = next((n for n in names if n in m.group(1)), None)
            t = re.search(r"ILi(\d+)E", m.group(1))
            if cur and t:
                cur += f"<{t.group(1)}>"
            # a type argument (the lifting) or a (bool, int) pair
            t = re.search(r"(Lift(?:53|97i|97f))|ILb(\d)ELi(\d+)E",
                          m.group(1))
            if cur and t:
                cur += f"<{t.group(1) or t.group(2) + ',' + t.group(3)}>"
        elif cur and "Used" in ln:
            out[cur] = ln.split("Used", 1)[1].strip()
            cur = None
    return out


def _cleanup_check(args, segments, qw, qh, msc):
    """The HT cleanup kernels against their plain versions on the lanes of
    `args` (a device program's lane arguments, on the card; `segments` the
    (lcup, pcup) of its decoded lanes): the VLC pass (records exact), the
    MagSgn pass on the same records, and the pair against ``cleanup_ref``.
    Raises on any difference. Returns, for "vlc", "magsgn" and "pair", the
    max abs error, the kernel's ms by CUDA events, the plain version's ms
    (host clock, one call) and the bound from the bytes these lanes need;
    and the lanes' sizes under "lanes"."""
    (msw, melw, vlcw, pLSB, maxbp, ms_lim, mel_lim, qws, qhs) = (
        args[k] for k in ("msw", "melw", "vlcw", "pLSB", "maxbp", "ms_lim",
                          "mel_lim", "qws", "qhs"))
    N = msw.shape[0]
    vlc_in = (melw, vlcw, mel_lim, qws, qhs, qw, qh)
    u32 = lambda t: t.to(torch.int64) & 0xFFFFFFFF
    plain = _plain

    rec_k = ht_scan.ht_vlc_pass(*vlc_in)
    rec_r, vlc_plain_ms = plain(ht_scan.vlc_pass_ref, *vlc_in)
    vlc_err = int((rec_k.to(torch.int64) - rec_r.to(torch.int64))
                  .abs().max())
    if vlc_err:
        raise RuntimeError(f"VLC pass differs from vlc_pass_ref (max abs "
                           f"err {vlc_err})")

    ms_in = (msw, pLSB, maxbp, ms_lim, qws, qhs, qw, qh, msc)
    mu_k, sig_k, ok_k = ht_scan.ht_magsgn_pass(rec_r, *ms_in)
    (mu_r, sig_r, ok_r), magsgn_plain_ms = plain(ht_scan.magsgn_pass_ref,
                                                 rec_r, *ms_in)
    if not torch.equal(ok_k, ok_r) or not bool(ok_r.all()):
        raise RuntimeError("MagSgn pass: ok flags differ from "
                           "magsgn_pass_ref or a lane failed")
    magsgn_err = max(int((u32(mu_k) - u32(mu_r)).abs().max()),
                     int((sig_k - sig_r).abs().max()))
    if magsgn_err:
        raise RuntimeError(f"MagSgn pass differs from magsgn_pass_ref "
                           f"(max abs err {magsgn_err})")

    lane_args = (msw, melw, vlcw, pLSB, maxbp, ms_lim, mel_lim, qws, qhs)
    mu_k, sig_k, ok_k = ht_scan.decode_cleanup_scan_dims(*lane_args, qw, qh,
                                                         msc)
    (mu_r, sig_r, ok_r), cleanup_plain_ms = plain(ht_scan.cleanup_ref,
                                                  *lane_args, qw, qh, msc)
    if not torch.equal(ok_k, ok_r) or not bool(ok_r.all()):
        raise RuntimeError("cleanup pair: ok flags differ from cleanup_ref"
                           " or a lane failed")
    cleanup_err = max(int((u32(mu_k) - u32(mu_r)).abs().max()),
                      int((sig_k - sig_r).abs().max()))
    if cleanup_err:
        raise RuntimeError(f"cleanup pair differs from cleanup_ref "
                           f"(max abs err {cleanup_err})")

    # bytes these inputs need: the segment bytes of the decoded lanes
    # (MagSgn: [0, pcup); MEL and VLC: [pcup, lcup)), the per-lane
    # vectors, the records, and mu + sig + ok
    lc, pc = segments
    ms_bytes = int(pc.astype(np.int64).sum())
    melvlc_bytes = int((lc - pc).astype(np.int64).sum())
    rec_bytes = 4 * N * qh * qw
    out_bytes = 4 * mu_k.numel() + 4 * sig_k.numel() + N
    return dict(
        lanes=dict(N=N, W=(msw.shape[1], melw.shape[1], vlcw.shape[1]),
                   ms_bytes=ms_bytes, melvlc_bytes=melvlc_bytes),
        vlc=dict(max_abs_err=vlc_err, plain_ms=vlc_plain_ms,
                 ms=_cuda_ms(lambda: ht_scan.ht_vlc_pass(*vlc_in), 10, True),
                 bound_ms=_bound(melvlc_bytes + 12 * N + 8192 + rec_bytes)),
        magsgn=dict(max_abs_err=magsgn_err, plain_ms=magsgn_plain_ms,
                    ms=_cuda_ms(lambda: ht_scan.ht_magsgn_pass(rec_r, *ms_in),
                                10, True),
                    bound_ms=_bound(rec_bytes + ms_bytes + 20 * N
                                    + out_bytes)),
        pair=dict(max_abs_err=cleanup_err, plain_ms=cleanup_plain_ms,
                  ms=_cuda_ms(lambda: ht_scan.decode_cleanup_scan_dims(
                      *lane_args, qw, qh, msc), 10, True),
                  bound_ms=_bound(ms_bytes + melvlc_bytes + 32 * N + 8192
                                  + out_bytes)))


def _rct_check(prog, outs):
    """The RCT kernel against its plain version on the three (H, W) int32
    planes after the inverse DWT of tile 0 of frame 0 of `prog` (its
    `outs`), on the card: as int32 planes, and written into an output at
    their dests of the program's frame layout (R, G, B interleaved and
    shifted in ``rgb48le``), the launch the program makes. Raises on any
    difference. Returns the max abs error, that launch's ms by CUDA
    events, the plain version's, the bound from the bytes moved, and the
    chroma plane's (min, max)."""
    idxs = prog.tci[0][:3]
    y0, y1, y2 = (outs[i].contiguous() for i in idxs)
    npx, cbps = y0.numel(), prog.cbps
    ref = mct_cuda.rct_writeframe_ref(y0, y1, y2, cbps)
    got = mct_cuda.rct_writeframe(y0, y1, y2, cbps)
    err = max(int((a - b).abs().max()) for a, b in zip(got, ref))
    dests = [prog.frame_layout.dests[i] for i in idxs]
    # one sentinel in both, so that a sample written where no dest puts
    # one differs too
    packed_k = torch.full((prog.frame_layout.frame_size,), 7,
                          dtype=prog.out_dtype, device=y0.device)
    packed_r = packed_k.clone()
    mct_cuda.rct_writeframe(y0, y1, y2, cbps, out=packed_k, dests=dests)

    def plain():
        mct_cuda.rct_writeframe_ref(y0, y1, y2, cbps, packed_r, dests)

    plain()
    err = max(err, int((packed_k.to(torch.int32)
                        - packed_r.to(torch.int32)).abs().max()))
    if err:
        raise RuntimeError(f"RCT kernel differs from its plain version "
                           f"(max abs err {err})")
    return dict(max_abs_err=err,
                ms=_cuda_ms(lambda: mct_cuda.rct_writeframe(
                    y0, y1, y2, cbps, out=packed_k, dests=dests), 20, True),
                plain_ms=_cuda_ms(plain, 20),
                bound_ms=_bound(3 * npx * (4 + packed_k.element_size())),
                chroma=(int(y1.min()), int(y1.max())))


def _print_cleanup(phase, c):
    for key, name in (("vlc", "VLC pass == vlc_pass_ref (records)"),
                      ("magsgn", "MagSgn pass == magsgn_pass_ref (same "
                                 "records)"),
                      ("pair", "pair == cleanup_ref")):
        m = c[key]
        print(f"{phase}   {name}: kernel {m['ms']:.4f} ms, plain "
              f"{m['plain_ms']:.1f} ms, bound {m['bound_ms']:.4f} ms "
              f"(bytes), {100 * m['bound_ms'] / m['ms']:.1f}% of bound")


def _c2_streams(rng):
    """BASELINE config 2's four frames, encoded by the port's encoder: two
    seeded natural value-noise frames, then two of bench.py's smooth
    frames (bench.py:348-350)."""
    base = _smooth(C2_H, C2_W, 255, np.uint8)
    sources = [_rgb(_natural(rng, C2_H, C2_W, 255, np.uint8))
               for _ in range(2)] \
        + [np.stack([np.roll(base, i, 1), base[::-1], base], 2)
           for i in range(2)]
    return [encode_frame_htj2k(f, **C2_ENC) for f in sources]


_KERNELS = {"ht_vlc_pass": ht_scan.ht_vlc_pass,
            "ht_magsgn_pass": ht_scan.ht_magsgn_pass,
            "rct_writeframe": mct_cuda.rct_writeframe,
            "ict_writeframe": mct_cuda.ict_writeframe,
            "ht_sigprop_pass": ht_refine.ht_sigprop_pass,
            "ht_magref_pass": ht_refine.ht_magref_pass,
            # the wrapper: one call launches the two refinement kernels
            "ht_refine": ht_refine.decode_refinement_scan,
            "wire_pack": wirepack.pack_words,
            # one count a call: the mosaic launch and the prefill launch
            "coef_mosaic": coef_cuda.coef_mosaic,
            # one count a launch: a DWT level of <= 48 planes (dwt_lift and
            # dwt_lift_program both count here)
            "dwt_lift": dwt_cuda.dwt_lift,
            # one count a launch of <= 48 buckets (the memset and the
            # prefill ride on the call)
            "bucket_scatter": coef_cuda.bucket_scatter,
            # one count a launch: every level under 8x8 of a program
            "dwt_small": dwt_cuda.dwt_small,
            # one count a launch: <= 160 planes without MCT
            "plane_writeframe": mct_cuda.plane_writeframe}
_REFINE = ("ht_sigprop_pass", "ht_magref_pass", "ht_refine")
# the counters a program's kernel_launches() gives
_PROGRAM = ("coef_mosaic", "bucket_scatter", "dwt_lift", "dwt_small",
            "plane_writeframe")


def _counts():
    return {k: fn.launches for k, fn in _KERNELS.items()}


def _reset_counts():
    for fn in _KERNELS.values():
        fn.launches = 0


def _lift_want(dec, data, frames: int, calls: int = 1):
    """{counter: n} of _PROGRAM: the launches of `calls` calls of the
    V3Program for `frames` frames that `dec` built for `data`'s geometry;
    zeros when it built none (the v2 and host routes)."""
    fg = dec._fast_geom(dec._parse(data))
    progs = [p for k, p in fg.v3_progs.items() if k[0] == frames]
    per = progs[0].kernel_launches() if progs else dict.fromkeys(_PROGRAM, 0)
    return {k: calls * n for k, n in per.items()}


def _v2_program(dec, streams, dev=None):
    """The BucketProgram ``dec.decode_batch(streams)`` runs on the flat
    lane (``Decoder._v2_args``, the decoder's cached program) and its
    arguments on `dev`: (program, (pf_idx, pf_val, bucket args)), or
    (program, None) without `dev`."""
    hdrs = [dec._parse(d) for d in streams]
    fg = dec._fast_geom(hdrs[0])
    geom, (shapes, bargs, pf_idx, pf_val), _accum = dec._v2_args(
        fg, [FP.parse_frame_flat(h, fg) for h in hdrs])
    up = lambda v: to_torch(v, dev) if isinstance(v, np.ndarray) else v
    prog = DEC.bucket_program(tuple(map(tuple, shapes)), geom.key(),
                              dec._layout(hdrs, fg.geom).replicate(len(hdrs)))
    if dev is None:
        return prog, None
    return prog, (up(pf_idx), up(pf_val),
                  [{k: up(v) for k, v in a.items()} for a in bargs])


def _v2_want(dec, streams):
    """{counter: n} of _PROGRAM and the entropy stage's: what one call of
    that BucketProgram launches (a cleanup pair a bucket, a refinement
    pair a refined bucket)."""
    prog, _args = _v2_program(dec, streams)
    refined = sum(1 for s in prog.shapes if s[5])
    return {"ht_vlc_pass": len(prog.shapes),
            "ht_magsgn_pass": len(prog.shapes),
            **dict.fromkeys(_REFINE, refined), **prog.kernel_launches()}


def _host_diff(frame, data, bitexact: bool):
    """(max abs difference, samples that differ) against the host oracle."""
    want = host_decoder.decode_frame(data, bitexact=bitexact)
    if frame.fmt.name != want.fmt.name:
        raise RuntimeError(f"{frame.fmt.name} != host {want.fmt.name}")
    a = np.frombuffer(frame.tobytes(), np.uint8).astype(np.int64)
    b = np.frombuffer(want.tobytes(), np.uint8).astype(np.int64)
    if a.shape != b.shape:
        raise RuntimeError(f"{a.shape} samples != host {b.shape}")
    d = np.abs(a - b)
    return int(d.max()), int((d != 0).sum())


def _ict_check(dec, streams, transform):
    """ICT kernel against its plain version on the c2 frames' planes after
    the inverse DWT, taken from the very program and lane arguments that
    ``dec.decode_batch(streams)`` runs, written where that program writes
    them (its frame layout: R, G, B interleaved in ``rgb24``): at that
    path's shape (one launch for the F frames) and at ``decode_stream``'s
    (one launch for one frame); also as int32 planes. Returns (the
    numbers, ms by CUDA events and bounds from the bytes moved; the
    program's lane arguments, its decoded lanes' (lcup, pcup) and the
    program itself, for the cleanup check)."""
    hdrs = [parse_codestream(d, bitexact=dec.bitexact) for d in streams]
    fg = dec._fast_geom(hdrs[0])
    cols_list = [FP.parse_frame_flat(h, fg) for h in hdrs]
    prog, args = dec._v3_program(fg, cols_list, dec._layout(hdrs, fg.geom))
    F, dev, cbps = prog.frames, args["msw"].device, prog.cbps
    if not prog.band_direct or prog.transform != transform:
        raise RuntimeError("c2 frames: expected the band-direct "
                           f"{transform} program")
    outs, _ok = prog.decode_planes(**args)
    ys = [tuple(c.contiguous() for c in outs[3 * f:3 * f + 3])
          for f in range(F)]
    npx = ys[0][0].numel()
    refs = [mct_cuda.ict_writeframe_ref(*y, cbps, transform) for y in ys]
    pairs = list(zip(mct_cuda.ict_writeframe(ys, cbps, transform), refs)) \
        + list(zip(mct_cuda.ict_writeframe(ys[:1], cbps, transform), refs))
    err = max(int((a - b).abs().max())
              for got, ref in pairs for a, b in zip(got, ref))
    lay = prog.frame_layout
    fs, dests = lay.frame_size, [lay.dests[i] for i in prog.tci[0][:3]]
    # one sentinel in all three outputs, so that a sample written where
    # no dest puts one differs too
    packed_k = torch.full((F * fs,), 7, dtype=prog.out_dtype, device=dev)
    packed_r = packed_k.clone()
    one_k = torch.full((fs,), 7, dtype=prog.out_dtype, device=dev)
    write = lambda frames, out: mct_cuda.ict_writeframe(
        frames, cbps, transform, out=out, frame_stride=fs, dests=dests)
    write(ys, packed_k)
    write(ys[:1], one_k)

    def plain():
        for f, y in enumerate(ys):
            mct_cuda.ict_writeframe_ref(
                *y, cbps, transform, packed_r,
                [(d + f * fs, rs, cs, sh) for d, rs, cs, sh in dests])

    plain()
    i32 = lambda t: t.to(torch.int32)
    err = max(err, int((i32(packed_k) - i32(packed_r)).abs().max()),
              int((i32(one_k) - i32(packed_r[:fs])).abs().max()))
    if err:
        raise RuntimeError(f"ICT kernel ({ys[0][0].dtype}) differs from its "
                           f"plain version (max abs err {err})")
    # three 4-byte planes read and the narrow samples written, per frame
    px_bytes = 3 * npx * (4 + packed_k.element_size())
    nums = dict(
        frames=F, max_abs_err=err, dtype=str(ys[0][0].dtype),
        layout=lay.fmt.name if lay.fmt else "identity",
        ms=_cuda_ms(lambda: write(ys, packed_k), 20, True),
        plain_ms=_cuda_ms(plain, 5),
        bound_ms=_bound(F * px_bytes),
        ms_one_frame=_cuda_ms(lambda: write(ys[:1], one_k), 20, True),
        bound_ms_one_frame=_bound(px_bytes),
        program_ms_per_frame=_cuda_ms(lambda: prog(**args), 3) / F)
    return nums, args, _v3_segments([FP.build_v3_frame(fg, c)
                                     for c in cols_list]), prog


_CLEANUP_ARGS = ("msw", "melw", "vlcw", "pLSB", "maxbp", "ms_lim", "mel_lim",
                 "qws", "qhs")


def _bits_err(a, b):
    """Max abs difference of two int32 or float32 tensors, by their bits
    for float32 (so any float difference counts, a NaN included)."""
    if a.shape != b.shape:
        raise RuntimeError(f"shapes {tuple(a.shape)} != {tuple(b.shape)}")
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    if not a.numel():
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def _lift_check(prog, args, reps: int = 0):
    """The two coefficient-stage kernels against their plain versions on a
    band-direct V3Program's own lanes (`args`, on the card): coef_mosaic
    on the cleanup kernels' mu; then the program's one dwt_lift_program
    call for every DWT level, each level of each plane against
    dwt_level_ref on that job's own inputs (the kernel's bands and the
    kernel's previous level), and the level-by-level entry dwt_lift on the
    same jobs. Raises on any difference, or if the call launched other
    than ``prog.kernel_launches()`` says. Returns, for each kernel, its max
    abs error (by bits for float32) and, with `reps`, its ms by CUDA events
    (dwt_lift: the one call), the plain version's ms (host clock, one
    synchronised call), the bound from the bytes these inputs need (each
    read once, each output written once); for dwt_lift also its ms level
    by level (dwt_lift a level), the launches of a call and the host ms of
    one call's wrapper work (host clock, calls queued behind a spin)."""
    mu, _sig, _ok = ht_scan.decode_cleanup_scan_dims(
        *(args[k] for k in _CLEANUP_ARGS), prog.qw, prog.qh, prog.ms_class)
    lay, t = prog.layout, prog.transform
    cin = (mu, args["magb"], args["istep"], args["scale97"], args["fscale"],
           args["pf_idx"], args["pf_val"], lay, t, prog.no_istep)
    bands = coef_cuda.coef_mosaic(*cin)
    ref, coef_plain_ms = _plain(coef_cuda.coef_mosaic_ref, *cin)
    coef = dict(max_abs_err=_bits_err(bands, ref))
    if coef["max_abs_err"]:
        raise RuntimeError(f"coef_mosaic differs from coef_mosaic_ref "
                           f"(max abs err by bits {coef['max_abs_err']})")
    before = dwt_cuda.dwt_lift.launches
    got = dwt_cuda.dwt_lift_program(prog.lift, bands)
    launched = dwt_cuda.dwt_lift.launches - before
    if launched != prog.kernel_launches()["dwt_lift"]:
        raise RuntimeError(f"dwt_lift_program launched {launched} times, "
                           f"expected {prog.kernel_launches()}")
    job = {(i, lev): prog.lift.view(got, j)
           for j, (i, lev, _w, _h) in enumerate(prog.lift.jobs)}
    views = lay.views(bands)
    outs = [views[i] for i in prog._ll]
    levels, err, samples = [], 0, 0
    for lev in range(prog.levels):
        todo, jobs = prog.level_jobs(lev, outs, views)
        one = dwt_cuda.dwt_lift(jobs, t)
        for i, o, j in zip(todo, one, jobs):
            want = dwt_torch.dwt_level_ref(*j[:6], t, j[6])
            err = max(err, _bits_err(job[i, lev], want), _bits_err(o, want))
            samples += o.numel()
            outs[i] = job[i, lev]
        levels.append(jobs)
    if err:
        raise RuntimeError(f"dwt_lift differs from dwt_level_ref (max abs "
                           f"err by bits {err})")
    lift = dict(max_abs_err=err)
    if reps:
        n_pf, N = args["pf_idx"].numel(), lay.n_lanes
        mapped = int((lay.table[:, 4] * lay.table[:, 5]).sum())
        # mu of the samples that land in a band, the table, the lane
        # vectors, the prefill entries; every band sample written once
        coef.update(
            plain_ms=coef_plain_ms,
            ms=_cuda_ms(lambda: coef_cuda.coef_mosaic(*cin), reps, True),
            bound_ms=_bound(4 * mapped + 4 * lay.total + 64 * N + 8 * n_pf),
            samples=lay.total, lanes=N)
        run = lambda: dwt_cuda.dwt_lift_program(prog.lift, bands)
        _r, lift_plain_ms = _plain(dwt_cuda.dwt_lift_program_ref, prog.lift,
                                   bands)
        host_ms = _host_ms(run, reps)
        # every band sample read once and every level's output written once
        lift.update(plain_ms=lift_plain_ms, ms=_cuda_ms(run, reps, True),
                    ms_by_level=[_cuda_ms(lambda: dwt_cuda.dwt_lift(jobs, t),
                                          reps, True) for jobs in levels],
                    bound_ms=_bound(8 * samples), samples=samples,
                    levels=len(levels), host_ms=host_ms,
                    launches_per_call=launched)
    return {"coef_mosaic": coef, "dwt_lift": lift}


@contextlib.contextmanager
def _plain_stages():
    """The programs' coefficient stages and write-out run as their plain
    torch versions on the card too (phases 11 and 12's "before", for the
    record)."""
    swaps = ((coef_cuda, "coef_mosaic"), (coef_cuda, "bucket_scatter"),
             (dwt_cuda, "dwt_lift_program"), (mct_cuda, "plane_writeframe"))
    saved = [getattr(mod, name) for mod, name in swaps]
    for mod, name in swaps:
        setattr(mod, name, getattr(mod, name + "_ref"))
    # a BucketProgram hands bucket_scatter its ScatterPlan, which the
    # plain version does not take
    coef_cuda.bucket_scatter = \
        lambda *a, plan=None: coef_cuda.bucket_scatter_ref(*a)
    try:
        yield
    finally:
        for (mod, name), fn in zip(swaps, saved):
            setattr(mod, name, fn)


def _device_ops(fn, reps: int = 3):
    """(device operations, device-busy ms) per call of fn(), from
    torch.profiler over `reps` calls after a warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in p.events() if e.device_type == DeviceType.CUDA]
    return (len(dev) / reps,
            sum(e.time_range.elapsed_us() for e in dev) / 1e3 / reps)


def _phase11(dev, c3_stream, c2_streams):
    """The v3 program's coefficient stages: coef_mosaic and dwt_lift
    against their plain versions on the main paths' own programs and
    lanes (c3's natural frame, 5/3; the c2 batch of four, integer and
    float 9/7), with times, bounds and shares; the V3Program's ms/frame,
    device operations and device-busy ms with the kernels and with the
    plain versions forced on the card. Returns {config: numbers}."""
    out = {}
    for name, streams, bitexact in (("c3", [c3_stream], True),
                                    ("c2_int", c2_streams, True),
                                    ("c2_float", c2_streams, False)):
        dec = Decoder(device=dev, bitexact=bitexact)
        hdrs = [dec._parse(d) for d in streams]
        fg = dec._fast_geom(hdrs[0])
        prog, args = dec._v3_program(fg, [FP.parse_frame_flat(h, fg)
                                          for h in hdrs],
                                     dec._layout(hdrs, fg.geom))
        if not prog.band_direct:
            raise RuntimeError(f"phase 11 {name}: not a band-direct program")
        F = prog.frames
        m = _lift_check(prog, args, reps=10)
        run = lambda: prog(**args)
        after = _cuda_ms(run, 5) / F
        ops_after, busy_after = _device_ops(run)
        with _plain_stages():
            before = _cuda_ms(run, 3) / F
            ops_before, busy_before = _device_ops(run)
        m["program"] = dict(
            frames=F, ms_per_frame=after, ms_per_frame_plain_stages=before,
            device_ops=ops_after, device_ops_plain_stages=ops_before,
            device_busy_ms=busy_after,
            device_busy_ms_plain_stages=busy_before)
        out[name] = m
        c, d = m["coef_mosaic"], m["dwt_lift"]
        print(f"phase 11 {name} ({F} frame(s), {c['lanes']} lanes, "
              f"{c['samples']} band samples, {d['levels']} levels, "
              f"transform {prog.transform}): coef_mosaic == coef_mosaic_ref: kernel "
              f"{c['ms']:.4f} ms, plain {c['plain_ms']:.2f} ms, bound "
              f"{c['bound_ms']:.4f} ms (bytes), "
              f"{100 * c['bound_ms'] / c['ms']:.1f}% of bound; dwt_lift "
              f"== dwt_level_ref at every level, one dwt_lift_program call "
              f"({d['launches_per_call']} launches, wrapper host "
              f"{d['host_ms']:.4f} ms): kernel {d['ms']:.4f} ms, plain "
              f"{d['plain_ms']:.2f} ms, bound {d['bound_ms']:.4f} ms "
              f"(bytes, one pass), {100 * d['bound_ms'] / d['ms']:.1f}% of "
              f"bound (ms by level, lowest first: "
              f"{', '.join(f'{x:.4f}' for x in d['ms_by_level'])}); V3Program "
              f"{before:.3f} -> {after:.3f} ms/frame, device ops "
              f"{ops_before:.0f} -> {ops_after:.0f} a call, device busy "
              f"{busy_before:.3f} -> {busy_after:.3f} ms a call (plain "
              f"stages forced -> kernels)")
        del args
    return out


def _job_samples(table):
    return sum(w * h for w, h in table[:, 7:9].tolist())


def _program_check(prog, args, frames: int, reps: int = 0):
    """The coefficient stages and the write-out of one program against
    their plain versions on its own lanes (`args`, on the card), by bits:
    a BucketProgram's ``bucket_scatter`` (on its entropy stage's mu) or a
    V3Program's ``coef_mosaic`` (on its cleanup's mu); then its one
    ``dwt_lift_program`` call (the levels under 8x8 through ``dwt_small``,
    the others through ``dwt_lift``, strided jobs on the flat buffer)
    against ``dwt_lift_program_ref``; then ``plane_writeframe`` on the
    program's own planes without MCT against ``plane_writeframe_ref``.
    Raises on any difference, or on launches other than
    ``prog.kernel_launches()``. Returns, per kernel, its max abs error
    and launches a call and, with `reps`, its ms by CUDA events (launches
    queued behind a spin), the plain version's ms (host clock, one
    synchronised call) and its bound from the bytes these inputs need;
    ``bucket_scatter`` also the ms of an ``index_put_`` of the same
    values at a precomputed index (the nearest single PyTorch call, no
    dequant); and, under "program", the program's ms a frame, device
    operations and device-busy ms with the kernels and with the plain
    stages forced on the card."""
    t, want, plan = prog.transform, prog.kernel_launches(), prog.lift
    bucket = isinstance(prog, ASM.BucketProgram)
    out = {}

    def launched(name, fn):
        before = _KERNELS[name].launches
        res = fn()
        n = _KERNELS[name].launches - before
        if n != want[name]:
            raise RuntimeError(f"{name}: {n} launches, expected {want}")
        return res, n

    if bucket:
        pf_idx, pf_val, bargs = args
        mus, _oks = prog.entropy(bargs)
        sin = (mus, prog.dims, bargs, pf_idx, pf_val, prog.total, t,
               prog.no_istep)
        scatter = lambda: coef_cuda.bucket_scatter(*sin, plan=prog.scatter)
        buf, n = launched("bucket_scatter", scatter)
        ref, plain_ms = _plain(coef_cuda.bucket_scatter_ref, *sin)
        m = dict(max_abs_err=_bits_err(buf, ref), launches_per_call=n)
        if m["max_abs_err"]:
            raise RuntimeError(f"bucket_scatter differs from "
                               f"bucket_scatter_ref ({m['max_abs_err']})")
        if reps:
            dev = buf.device
            idx = torch.cat([
                (a["dest"][:a["nreal"]].long()[:, None, None]
                 + torch.arange(h, device=dev)[None, :, None]
                 * a["stride"][:a["nreal"]].long()[:, None, None]
                 + torch.arange(w, device=dev)[None, None, :]).reshape(-1)
                for a, (w, h) in zip(bargs, prog.dims)])
            vals, yard = ref[idx], torch.zeros_like(ref)
            n_real = idx.numel()
            # the real samples' mu read, the flat buffer written, the
            # prefill entries and the real lanes' six vectors read
            lanes = sum(a["nreal"] for a in bargs)
            m.update(ms=_cuda_ms(scatter, reps, True),
                     host_ms=_host_ms(scatter, reps),
                     plain_ms=plain_ms,
                     bound_ms=_bound(4 * n_real + 4 * (prog.total + 1)
                                     + 8 * pf_idx.numel() + 24 * lanes),
                     index_put_ms=_cuda_ms(
                         lambda: yard.index_put_((idx,), vals), reps, True),
                     samples=n_real, buckets=len(prog.shapes), lanes=lanes)
            del idx, vals, yard
        out["bucket_scatter"] = m
    else:
        mu, _sig, _ok = ht_scan.decode_cleanup_scan_dims(
            *(args[k] for k in _CLEANUP_ARGS), prog.qw, prog.qh,
            prog.ms_class)
        lay = prog.layout
        cin = (mu, args["magb"], args["istep"], args["scale97"],
               args["fscale"], args["pf_idx"], args["pf_val"], lay, t,
               prog.no_istep)
        buf, n = launched("coef_mosaic", lambda: coef_cuda.coef_mosaic(*cin))
        ref, plain_ms = _plain(coef_cuda.coef_mosaic_ref, *cin)
        m = dict(max_abs_err=_bits_err(buf, ref), launches_per_call=n)
        if m["max_abs_err"]:
            raise RuntimeError(f"coef_mosaic differs from coef_mosaic_ref "
                               f"({m['max_abs_err']})")
        if reps:
            mapped = int((lay.table[:, 4] * lay.table[:, 5]).sum())
            m.update(ms=_cuda_ms(lambda: coef_cuda.coef_mosaic(*cin), reps,
                                 True),
                     plain_ms=plain_ms,
                     bound_ms=_bound(4 * mapped + 4 * lay.total
                                     + 64 * lay.n_lanes
                                     + 8 * args["pf_idx"].numel()),
                     samples=lay.total, lanes=lay.n_lanes)
        out["coef_mosaic"] = m
    del ref

    # the inverse DWT: one call, both kernels, job by job against the plain
    # version
    before = dwt_cuda.dwt_small.launches
    scratch, n_lift = launched(
        "dwt_lift", lambda: dwt_cuda.dwt_lift_program(plan, buf))
    n_small = dwt_cuda.dwt_small.launches - before
    if n_small != want["dwt_small"]:
        raise RuntimeError(f"dwt_small: {n_small} launches, expected {want}")
    ref, lift_plain_ms = _plain(dwt_cuda.dwt_lift_program_ref, plan, buf)
    errs = dict.fromkeys(("dwt_small", "dwt_lift"), 0)
    if _bits_err(scratch, ref):
        for key, table in (("dwt_small", plan.small_table),
                           ("dwt_lift", plan.table)):
            for o, w, h in table[:, 6:9].tolist():
                errs[key] = max(errs[key], _bits_err(scratch[o:o + w * h],
                                                     ref[o:o + w * h]))
        raise RuntimeError(f"dwt_lift_program differs from "
                           f"dwt_lift_program_ref (by bits: {errs})")
    del ref
    small = dict(max_abs_err=0, launches_per_call=n_small,
                 jobs=len(plan.small_table),
                 planes=len(plan.small_chains) - 1,
                 samples=_job_samples(plan.small_table),
                 shared_jobs=plan.small_shared,
                 device_jobs=plan.small_device)
    lift = dict(max_abs_err=0, launches_per_call=n_lift,
                jobs=len(plan.table), samples=_job_samples(plan.table),
                strided=bucket)
    if reps:
        # each kernel alone (the other's jobs dropped from a copy of the
        # plan for its plain version; the bound: each job's bands read
        # once and its output written once)
        base = buf.data_ptr()
        if small["jobs"]:
            alone = copy.copy(plan)
            alone.table = plan.table[:0]
            small.update(ms=_cuda_ms(lambda: dwt_cuda.dwt_small(
                plan, base, scratch), reps, True),
                plain_ms=_plain(dwt_cuda.dwt_lift_program_ref, alone,
                                buf)[1],
                bound_ms=_bound(8 * small["samples"]),
                latency_bound_ms=_small_latency_bound(plan))
        if lift["jobs"]:
            alone = copy.copy(plan)
            alone.small_table = plan.small_table[:0]
            lift.update(ms=_cuda_ms(lambda: dwt_cuda._launch(plan, base,
                                                             scratch),
                                    reps, True),
                        plain_ms=_plain(dwt_cuda.dwt_lift_program_ref, alone,
                                        buf)[1],
                        bound_ms=_bound(8 * lift["samples"]))
        lift.update(call_plain_ms=lift_plain_ms, call_ms=_cuda_ms(
            lambda: dwt_cuda.dwt_lift_program(plan, buf), reps, True))
    out["dwt_small"], out["dwt_lift"] = small, lift

    # the write-out of the planes without MCT
    if bucket:
        outs = [buf[off:off + ph * pw].view(ph, pw) if last is None
                else plan.view(scratch, last)
                for (off, ph, pw), last in zip(prog.planes, plan.last)]
    else:
        views = prog.layout.views(buf)
        outs = [views[ll] if last is None else plan.view(scratch, last)
                for ll, last in zip(prog._ll, plan.last)]
    planes, offs = prog.writes(outs)
    n_out = prog.frames * prog.frame_layout.frame_size + 1
    pk = torch.zeros(n_out, dtype=prog.out_dtype, device=buf.device)
    pr = torch.zeros_like(pk)
    win = (planes, prog.cbps, pk, offs)
    _r, n = launched("plane_writeframe",
                     lambda: mct_cuda.plane_writeframe(*win))
    _r, plain_ms = _plain(mct_cuda.plane_writeframe_ref, planes, prog.cbps,
                          pr, offs)
    i32 = lambda x: x.to(torch.int32)
    m = dict(max_abs_err=_bits_err(i32(pk), i32(pr)), launches_per_call=n,
             planes=len(planes), samples=sum(p.numel() for p in planes))
    if m["max_abs_err"]:
        raise RuntimeError(f"plane_writeframe differs from "
                           f"plane_writeframe_ref ({m['max_abs_err']})")
    if reps and planes:
        m.update(ms=_cuda_ms(lambda: mct_cuda.plane_writeframe(*win), reps,
                             True),
                 plain_ms=plain_ms,
                 bound_ms=_bound(m["samples"] * (4 + pk.element_size())))
    out["plane_writeframe"] = m
    del outs, planes, scratch, buf, pk, pr, win
    if reps:
        run = (lambda: prog(*args)) if bucket else (lambda: prog(**args))
        after = _cuda_ms(run, 5) / frames
        ops_after, busy_after = _device_ops(run)
        with _plain_stages():
            before = _cuda_ms(run, 3) / frames
            ops_before, busy_before = _device_ops(run)
        out["program"] = dict(
            frames=frames, ms_per_frame=after,
            ms_per_frame_plain_stages=before, device_ops=ops_after,
            device_ops_plain_stages=ops_before, device_busy_ms=busy_after,
            device_busy_ms_plain_stages=busy_before)
    return out


def _fmt_kernel(name, m):
    """One kernel's numbers from _program_check, for a phase 12 line."""
    if "ms" not in m:
        return f"{name}: no work here"
    share = 100 * m["bound_ms"] / m["ms"]
    extra = ""
    if "host_ms" in m:
        extra += f", wrapper host {m['host_ms']:.4f} ms"
    if "latency_bound_ms" in m:
        extra += (f", latency bound {m['latency_bound_ms']:.5f} ms "
                  f"({100 * m['latency_bound_ms'] / m['ms']:.1f}%), jobs "
                  f"in shared / device memory {m['shared_jobs']} / "
                  f"{m['device_jobs']}")
    return (f"{name} == plain ({m['launches_per_call']} launch(es) a call): "
            f"kernel {m['ms']:.4f} ms, plain {m.get('plain_ms', 0):.2f} ms, "
            f"bound {m['bound_ms']:.5f} ms (bytes), {share:.1f}% of bound"
            + extra)


# BASELINE config 4's frame (7680x4320, 1024x1024 tiles) has four tile
# shapes: 1024x1024, its right column's 512x1024 and its bottom row's
# 1024x224 and 512x224, whose lowest DWT levels are 32x7 and 16x7 (under
# 8x8). A 1536x1248 crop of the frame's extent holds one tile of each.
C12_W, C12_H = 1536, 1248
C12_SINGLE = {k: v for k, v in C4_ENC.items()
              if k not in ("refinement", "ht_layers")}
# the c4 decode_batch [A, B, A, B] program's device operations before
# this phase's kernels: torch.profiler over the program on an H100
# 80GB HBM3 at 700 W (PERF.md, section 5)
C4_PROGRAM_OPS_BEFORE = 2395
# and the most it may run now: its kernels, the bitmap's memset and the ok
# flag's operations, no torch op a bucket
C4_PROGRAM_OPS_MAX = 40


def _phase12(dev, c4_data):
    """The v2 program and the flat fallback on their kernels: on phase 7's
    decode_batch [A, B, A, B] program and on a 1536x1248 crop of config 4
    encoded twice (layered: a BucketProgram with levels under 8x8;
    single-layer: a V3Program with them), ``bucket_scatter``, the flat
    ``dwt_lift_program`` (``dwt_small`` and strided ``dwt_lift`` jobs),
    ``coef_mosaic`` and ``plane_writeframe`` against their plain
    versions, with times, bounds and shares, and each program with the
    kernels and with the plain stages forced; then the crop's two streams
    through ``Decoder.decode`` (counts reset before, read after, == the
    source). Returns ({input: numbers}, {path: (launch counts, frames)},
    the three kernels' ptxas lines)."""
    t0 = time.perf_counter()
    src = _grainy(np.random.default_rng(4044), C12_H, C12_W)
    layered = encode_frame_htj2k(src, **C4_ENC)
    single = encode_frame_htj2k(src, **C12_SINGLE)
    print(f"phase 12 encode (port encoder): a {C12_W}x{C12_H} crop of "
          f"grainy natural content (config 4's four tile shapes, cut from "
          f"7680x4320), 2 HT layers (the v2 path) and one (a V3Program "
          f"with levels under 8x8), {len(layered) / 1e6:.2f} and "
          f"{len(single) / 1e6:.2f} MB, {time.perf_counter() - t0:.1f} s")
    (_srcs, (A, B)) = c4_data
    dec = Decoder(device=dev)
    out = {}
    for name, streams in (("c4_batch", [A, B, A, B]), ("crop_v2", [layered]),
                          ("crop_v3", [single])):
        if name == "crop_v3":
            hdrs = [dec._parse(d) for d in streams]
            fg = dec._fast_geom(hdrs[0])
            prog, args = dec._v3_program(fg, [FP.parse_frame_flat(h, fg)
                                              for h in hdrs],
                                         dec._layout(hdrs, fg.geom))
            if prog.band_direct:
                raise RuntimeError("phase 12 crop_v3: no level under 8x8")
        else:
            prog, args = _v2_program(dec, streams, dev)
        m = _program_check(prog, args, len(streams), reps=10)
        out[name] = m
        p = m["program"]
        coef = "bucket_scatter" if "bucket_scatter" in m else "coef_mosaic"
        yard = (f" (index_put_ of the same values: "
                f"{m[coef]['index_put_ms']:.4f} ms)"
                if "index_put_ms" in m[coef] else "")
        print(f"phase 12 {name} ({type(prog).__name__}, {len(streams)} "
              f"frame(s), {len(prog.planes)} planes a frame, "
              f"{m['dwt_small']['jobs']} small and {m['dwt_lift']['jobs']} "
              f"other DWT jobs): {_fmt_kernel(coef, m[coef])}{yard}; "
              + "; ".join(_fmt_kernel(k, m[k]) for k in
                          ("dwt_small", "dwt_lift", "plane_writeframe"))
              + f"; dwt_lift_program call {m['dwt_lift']['call_ms']:.4f} "
              f"ms; program {p['ms_per_frame_plain_stages']:.3f} -> "
              f"{p['ms_per_frame']:.3f} ms/frame, device ops "
              f"{p['device_ops_plain_stages']:.0f} -> {p['device_ops']:.0f} "
              f"a call, busy {p['device_busy_ms_plain_stages']:.3f} -> "
              f"{p['device_busy_ms']:.3f} ms (plain stages forced -> "
              f"kernels)")
        del args
    c4p = out["c4_batch"]["program"]
    print(f"phase 12 c4 batch program: {c4p['device_ops']:.0f} device "
          f"operations against {C4_PROGRAM_OPS_BEFORE} before this phase's "
          f"kernels ({C4_PROGRAM_OPS_BEFORE / c4p['device_ops']:.1f}x "
          "fewer)")
    if 20 * c4p["device_ops"] > C4_PROGRAM_OPS_BEFORE \
            or c4p["device_ops"] > C4_PROGRAM_OPS_MAX:
        raise RuntimeError("phase 12: the c4 batch program's device "
                           "operations fell less than twentyfold, or "
                           f"exceed {C4_PROGRAM_OPS_MAX}")

    # the crop through the public entry point: one decoder a stream
    paths = {}
    for name, data, route in (("crop_v2", layered, (0, 1, 0)),
                              ("crop_v3", single, (1, 0, 0))):
        d = Decoder(device=dev)
        _reset_counts()
        frame = d.decode(data)
        counts = _counts()
        want = dict.fromkeys(_KERNELS, 0)
        want.update(_v2_want(d, [data]) if route[1] else
                    {"ht_vlc_pass": 1, "ht_magsgn_pass": 1,
                     **_lift_want(d, data, 1)})
        if counts != want or (d.v3_frames, d.v2_frames, d.host_frames) \
                != route or not _same(frame, src, 10):
            raise RuntimeError(f"phase 12 {name} decode: launches {counts} "
                               f"(expected {want}), route "
                               f"{(d.v3_frames, d.v2_frames, d.host_frames)}"
                               f", == source {_same(frame, src, 10)}")
        paths[f"c12_{name}_decode"] = (counts, 1)
        print(f"phase 12 {name} Decoder.decode: == source "
              f"({frame.fmt.name}), route (v3, v2, host) {route}, launches "
              f"{counts}")
    regs = _ptxas(build.load().log, ("scatter_lanes", "scatter_zeros",
                                     "scatter_prefill", "small_levels",
                                     "writeframe_kernel"))
    print("phase 12 ptxas: " + "; ".join(f"{k}: {v}" for k, v in
                                         regs.items())
          + f"; {time.perf_counter() - t0:.1f} s")
    return out, paths, regs


def _phase6(dev):
    """The c2 irreversible path; returns (the ict_writeframe entry of the
    kernels line without its launches, the HT cleanup kernels' check at
    this path's lanes, {path: (launch counts, frames)} of the float
    decode_batch and of the integer decode_stream, the four streams)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(2025)
    streams = _c2_streams(rng)
    print(f"phase 6 encode (port encoder): {len(streams)} frames "
          f"{C2_W}x{C2_H} 8-bit RGB 9/7+ICT (2 natural, 2 smooth), "
          f"{sum(map(len, streams)) / len(streams) / 1e6:.2f} MB/frame avg,"
          f" {time.perf_counter() - t0:.1f} s")

    dec_f = Decoder(device="cuda", bitexact=False)
    dec_i = Decoder(device="cuda", bitexact=True)
    modes, lanes = {}, None
    for name, dec, transform in (("float", dec_f, DWT97),
                                 ("int", dec_i, DWT97_INT)):
        m, args, segs, prog = _ict_check(dec, streams, transform)
        modes[name] = m
        print(f"phase 6   ict {name} mode == ict_writeframe_ref in the "
              f"{m['layout']} layout on "
              f"{m['frames']} frames of 3 x {C2_H}x{C2_W} {m['dtype']} "
              f"planes, one launch: kernel {m['ms']:.4f} ms, plain "
              f"{m['plain_ms']:.3f} ms, bound {m['bound_ms']:.4f} ms "
              f"(bytes), {100 * m['bound_ms'] / m['ms']:.1f}% of bound; "
              f"one frame (== plain too): {m['ms_one_frame']:.4f} ms, "
              f"{100 * m['bound_ms_one_frame'] / m['ms_one_frame']:.1f}% "
              f"of bound; device program {m['program_ms_per_frame']:.2f} "
              f"ms/frame (F={m['frames']})")
        if lanes is None:      # the lanes are the same in both modes
            lanes = (args, segs, prog.qw, prog.qh, prog.ms_class)
        del args

    # the HT cleanup kernels at this path's lanes: F frames in one launch
    c2 = _cleanup_check(*lanes)
    ln = c2["lanes"]
    print(f"phase 6 HT cleanup on the {len(streams)} frames' {ln['N']} lanes "
          f"(qw=qh={lanes[2]}, ms_class={lanes[4]}, W ms/mel/vlc = "
          f"{'/'.join(map(str, ln['W']))}; segment bytes MagSgn "
          f"{ln['ms_bytes']}, MEL+VLC {ln['melvlc_bytes']})")
    _print_cleanup("phase 6", c2)
    del lanes

    # the main path: decode_batch of the four frames, float 9/7
    _reset_counts()
    frames = dec_f.decode_batch(streams)
    batch_counts = _counts()
    want = {"ht_vlc_pass": 1, "ht_magsgn_pass": 1, "rct_writeframe": 0,
            "ict_writeframe": 1, **dict.fromkeys(_REFINE, 0),
            "wire_pack": 0, **_lift_want(dec_f, streams[0], len(streams))}
    if batch_counts != want:
        raise RuntimeError(f"decode_batch launches {batch_counts}, "
                           f"expected {want}")
    if dec_f.v3_frames != len(streams) or dec_f.host_frames:
        raise RuntimeError(f"decode_batch: v3 frames {dec_f.v3_frames}, "
                           f"host frames {dec_f.host_frames}")
    diffs = [_host_diff(fr, s, False) for fr, s in zip(frames, streams)]
    if any(d > 1 for d, _n in diffs) or frames[0].fmt.name != "rgb24":
        raise RuntimeError(f"decode_batch vs host float oracle: {diffs}")
    print(f"phase 6 decode_batch (bitexact=False): {len(frames)} rgb24 "
          f"frames in one program, launches {batch_counts}; vs the host "
          "float oracle (max abs diff, samples off): "
          + ", ".join(f"({d}, {n})" for d, n in diffs))

    # the integer path, frame by frame: byte-equal to the host oracle
    _reset_counts()
    frames = list(dec_i.decode_stream(streams))
    int_counts = _counts()
    want = {"ht_vlc_pass": len(streams), "ht_magsgn_pass": len(streams),
            "rct_writeframe": 0, "ict_writeframe": len(streams),
            **dict.fromkeys(_REFINE, 0), "wire_pack": 0,
            **_lift_want(dec_i, streams[0], 1, len(streams))}
    if dec_i.v3_frames != len(streams) or dec_i.host_frames \
            or int_counts != want:
        raise RuntimeError(f"decode_stream (bitexact): v3 frames "
                           f"{dec_i.v3_frames}, host frames "
                           f"{dec_i.host_frames}, launches {int_counts}")
    diffs = [_host_diff(fr, s, True) for fr, s in zip(frames, streams)]
    if any(d for d, _n in diffs):
        raise RuntimeError(f"decode_stream (bitexact) vs host: {diffs}")
    # the flat-DWT fallback: a 96x128 frame whose lowest level is 8x6
    small = encode_frame_htj2k(
        _rgb(_natural(rng, 96, 128, 255, np.uint8)), pred=0, mct=True,
        nreslevels=6, log2_cblk_width=5, log2_cblk_height=5)
    flat_diff = _host_diff(dec_i.decode(small), small, True)
    fg = dec_i._fast_geom(parse_codestream(small, bitexact=True))
    if flat_diff[0] or [p.band_direct for p in fg.v3_progs.values()] \
            != [False]:
        raise RuntimeError(f"flat-DWT fallback stream: {flat_diff}")
    print(f"phase 6 decode_stream (bitexact=True): {len(frames)} frames "
          f"byte-equal to the host integer oracle, all via the v3 device "
          f"program, launches {int_counts}; flat-DWT fallback 96x128 "
          "stream byte-equal too")

    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec_f.decode_batch(streams)
        times.append((time.perf_counter() - t0) * 1e3 / len(streams))
    print(f"phase 6 one batch of {len(streams)}, ms: "
          + _laps(dec_f, streams, False, dev))
    res = dec_f.bench_resident(streams, n_it=10, reps=3)
    if res["frames_merged"] != len(streams):
        raise RuntimeError(f"bench_resident: {res}")
    print(f"phase 6 decode_batch end to end: median "
          f"{statistics.median(times):.2f} ms/frame over {REPS} batches of "
          f"{len(streams)} ({', '.join(f'{t:.2f}' for t in times)}); "
          f"bench_resident F={res['frames_merged']}: "
          f"{res['ms_per_frame']:.3f} ms/frame ({res['fps']:.1f} fps)")

    f = modes["float"]
    entry = dict(name="ict_writeframe", route="cuda",
                 source="ffmpeg_ht_tpu_torch/csrc/ict_writeframe.cu",
                 replaces="ffmpeg_ht_tpu/models/assembly.py:390",
                 max_abs_err=max(m["max_abs_err"] for m in modes.values()),
                 ms=f["ms"], plain_ms=f["plain_ms"], bound_ms=f["bound_ms"],
                 modes=modes)
    paths = {"c2_decode_batch": (batch_counts, len(streams)),
             "c2_decode_stream_int": (int_counts, len(streams))}
    return entry, c2, paths, streams


def _c4_streams():
    """BASELINE config 4's crop: two seeded grainy natural frames and their
    streams, encoded by the port's encoder."""
    srcs = [_grainy(np.random.default_rng(seed), C4_H, C4_W)
            for seed in (4040, 4041)]
    return srcs, [encode_frame_htj2k(x, **C4_ENC) for x in srcs]


def _zblk_hist(fg, cols):
    """z_blk histograms of a frame's codeblocks, all included ones and the
    device lanes alone; the host-oracle lanes (under _HOST_AREA samples,
    or maxbp > 25) and how many of them have maxbp > 25."""
    act, npasses = cols["active"], cols["npasses"]
    rem = npasses % 3
    plhd = np.where(rem, npasses - rem, npasses - 3)
    zblk = npasses - plhd
    deep = act & (cols["zbp"] + plhd // 3 + 1 > 25)
    dev = act & ~fg.area_small & ~deep
    return ({z: int(((zblk == z) & act).sum()) for z in (1, 2, 3)},
            {z: int(((zblk == z) & dev).sum()) for z in (1, 2, 3)},
            int((act & ~dev).sum()), int(deep.sum()))


def _dref_bytes(lref, zb):
    """The refinement bytes of lanes with Dref lengths `lref` and z_blk
    `zb`, as finish_buckets caps them: SigProp's prefix (z_blk >= 2) and
    MagRef's suffix (z_blk 3) of one segment. (In all, SigProp's,
    MagRef's.)"""
    lref, zb = np.asarray(lref, np.int64), np.asarray(zb)
    cap = np.where(zb >= 3, FP.SP_CAP + FP.MR_CAP, FP.SP_CAP)
    return (int(np.where(zb >= 2, np.minimum(lref, cap), 0).sum()),
            int(np.where(zb >= 2, np.minimum(lref, FP.SP_CAP), 0).sum()),
            int(np.where(zb >= 3, np.minimum(lref, FP.MR_CAP), 0).sum()))


def _v2_buckets(dec, streams):
    """The buckets of the v2 program Decoder.decode_batch dispatches for
    same-geometry `streams` (``Decoder._v2_args``, which _fast_batch and
    _fast_launch call): (shapes, numpy bucket arrays, per bucket its lanes'
    cleanup (lcup, pcup) and the refinement bytes its lanes hold: in all,
    those SigProp reads, those MagRef reads)."""
    hdrs = [dec._parse(d) for d in streams]
    fg = dec._fast_geom(hdrs[0])
    _geom, (shapes, bargs, _pf_idx, _pf_val), accum = dec._v2_args(
        fg, [FP.parse_frame_flat(h, fg) for h in hdrs])
    segs = []
    for key in sorted(accum["buckets"]):
        lc, pc, lrefs, zbs = [], [], [], []
        for body, off, lcup, lref, zb in accum["buckets"][key]["rows"]:
            b = np.frombuffer(body, np.uint8)
            scup = (b[off + lcup - 1].astype(np.int64) << 4) \
                + (b[off + lcup - 2] & 0x0F)
            lc.append(lcup)
            pc.append(lcup - scup)
            lrefs.append(lref)
            zbs.append(zb)
        segs.append((np.concatenate(lc), np.concatenate(pc),
                     *_dref_bytes(np.concatenate(lrefs),
                                  np.concatenate(zbs))))
    return shapes, bargs, segs


def _object_buckets(dec, data):
    """As ``_v2_buckets``, for the object path's BucketProgram
    (``Decoder._device_decode``: ``_build_batch``, then each bucket's
    ``_Bucket.pack`` in key order, as ``Decoder._dispatch`` packs them),
    and that BucketProgram with its arguments on the card: ("v2", shapes,
    bucket arrays, segments, program, (pf_idx, pf_val, bucket args))."""
    hdr = dec._parse(data)
    geom, buckets, prefill = DEC._build_batch(hdr, dec._parse_tiles(hdr))
    shapes, bargs, segs = [], [], []
    for key in sorted(buckets):
        b = buckets[key]
        shape, args = b.pack()
        shapes.append(shape)
        bargs.append(args)
        segs.append((np.asarray(b.lcup), np.asarray(b.pcup),
                     *_dref_bytes(b.lref, b.zblk)))
    nz = np.nonzero(prefill[:-1])[0]
    pf_idx = nz.astype(np.int32) if len(nz) else \
        np.array([geom.total], np.int32)
    pf_val = prefill[nz] if len(nz) else np.zeros(1, prefill.dtype)
    up = lambda v: to_torch(v, dec.device) if isinstance(v, np.ndarray) \
        else v
    prog = DEC.bucket_program(tuple(map(tuple, shapes)), geom.key(),
                              dec._layout([hdr], geom))
    return ("v2", shapes, bargs, segs, prog, (
        up(pf_idx), up(pf_val), [{k: up(v) for k, v in a.items()}
                                 for a in bargs]))


def _v2_kernel_checks(dev, shapes, bargs, segs):
    """On every bucket of a v2 program, the cleanup kernels against their
    plain versions (``_cleanup_check``). On every refined bucket, from the
    kernel cleanup's (mu, sig): ``ht_sigprop_pass`` against
    ``sigprop_pass_ref`` (its words), ``ht_magref_pass`` against
    ``magref_pass_ref`` given the plain words, and the pair
    (``decode_refinement_scan``) against ``refine_ref``. Raises on any
    difference. Returns the cleanup numbers summed over the buckets; the
    refinement's under "magref", "sigprop" and "pair", summed and by
    bucket (ms by CUDA events with a head start, bounds from the bytes);
    and the refined buckets' count, lanes and shapes."""
    up = lambda v: to_torch(v, dev) if isinstance(v, np.ndarray) else v
    u32 = lambda t: t.to(torch.int64) & 0xFFFFFFFF
    diff = lambda a, b: int((u32(a) - u32(b)).abs().max())
    clean = {k: dict(max_abs_err=0, ms=0.0, plain_ms=0.0, bound_ms=0.0)
             for k in ("vlc", "magsgn", "pair")}
    ref = {k: dict(max_abs_err=0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                   ms_by_bucket=[], bound_ms_by_bucket=[])
           for k in ("sigprop", "magref", "pair")}
    info = dict(buckets=0, lanes=0, shapes=[])
    for (qw, qh, w, h, msc, refined), a, (lc, pc, dref, sp_b, mr_b) in zip(
            shapes, bargs, segs):
        t = {k: up(v) for k, v in a.items()}
        t["qws"], t["qhs"] = ht_scan._bucket_dims(t["msw"], qw, qh,
                                                  a["nreal"])
        c = _cleanup_check(t, (lc, pc), qw, qh, msc)
        for k, m in clean.items():
            m["max_abs_err"] = max(m["max_abs_err"], c[k]["max_abs_err"])
            for f in ("ms", "plain_ms", "bound_ms"):
                m[f] += c[k][f]
        if not refined:
            continue
        mu, sig, _ok = ht_scan.decode_cleanup_scan_sig(
            t["msw"], t["melw"], t["vlcw"], t["pLSB"], t["maxbp"],
            t["ms_lim"], t["mel_lim"], qw, qh, msc, a["nreal"])
        s_in = (sig, t["spw"], t["has_sp"], t["causal"], qw, qh, w, h)
        rargs = (mu, sig, t["spw"], t["mrw"], t["pLSB"], t["has_sp"],
                 t["has_mr"], t["causal"], qw, qh, w, h)
        words_k = ht_refine.ht_sigprop_pass(*s_in)
        words_r, s_plain = _plain(ht_refine.sigprop_pass_ref, *s_in)
        m_in = (mu, sig, t["mrw"], t["pLSB"], t["has_mr"], words_r, qw, qh,
                w, h)
        got_m = ht_refine.ht_magref_pass(*m_in)
        want_m, m_plain = _plain(ht_refine.magref_pass_ref, *m_in)
        got = ht_refine.decode_refinement_scan(*rargs)
        want, p_plain = _plain(ht_refine.refine_ref, *rargs)
        errs = dict(sigprop=diff(words_k, words_r), magref=diff(got_m, want_m),
                    pair=diff(got, want))
        if any(errs.values()):
            raise RuntimeError(f"refinement kernels differ from their plain "
                               f"versions on the {w}x{h} bucket (max abs "
                               f"err {errs})")
        ms = dict(
            sigprop=_cuda_ms(lambda: ht_refine.ht_sigprop_pass(*s_in), 10,
                             True),
            magref=_cuda_ms(lambda: ht_refine.ht_magref_pass(*m_in), 10,
                            True),
            pair=_cuda_ms(lambda: ht_refine.decode_refinement_scan(*rargs),
                          10, True))
        # bytes, the real lanes' only: the pair reads mu, the quad
        # patterns, pLSB and the three flags and the Dref bytes these lanes
        # hold, and writes mu; SigProp reads the quad patterns, two flags
        # and its Dref bytes and writes its words; MagRef reads mu, the
        # quad patterns, pLSB, a flag, its Dref bytes and the words, and
        # writes mu
        n = a["nreal"]
        word_bytes = 4 * words_r[:n].numel()
        nbytes = dict(
            sigprop=n * (4 * qh * qw + 2) + sp_b + word_bytes,
            magref=n * (2 * 4 * 4 * qh * qw + 4 * qh * qw + 5) + mr_b
            + word_bytes,
            pair=n * (2 * 4 * 4 * qh * qw + 4 * qh * qw + 7) + dref)
        plain = dict(magref=m_plain, sigprop=s_plain, pair=p_plain)
        for k, m in ref.items():
            m["max_abs_err"] = max(m["max_abs_err"], errs[k])
            m["ms"] += ms[k]
            m["plain_ms"] += plain[k]
            m["bound_ms"] += _bound(nbytes[k])
            m["ms_by_bucket"].append(ms[k])
            m["bound_ms_by_bucket"].append(_bound(nbytes[k]))
        info["buckets"] += 1
        info["lanes"] += n
        info["shapes"].append(f"{w}x{h}:{n}")
    return clean, ref, info


def _laps_v2(dec, streams, dev):
    """Where a v2 batch's time goes: the calls Decoder.decode_batch makes
    for `streams` (flat lane, v2 route), one by one with a device sync
    after each device step (host clock, ms for the whole batch)."""
    hdrs = [parse_codestream(d, bitexact=True) for d in streams]
    fg = dec._fast_geom(hdrs[0])

    layout = dec._layout(hdrs, fg.geom)

    def upload(v2):
        gm, (shapes, bargs, pf_idx, pf_val), _accum = v2
        up = lambda v: to_torch(v, dev) if isinstance(v, np.ndarray) else v
        return (DEC.bucket_program(tuple(map(tuple, shapes)), gm.key(),
                                   layout.replicate(len(hdrs))),
                up(pf_idx), up(pf_val),
                [{k: up(v) for k, v in a.items()} for a in bargs])

    laps, val = {}, None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for name, step in (
            ("parse", lambda _: [parse_codestream(d, bitexact=True)
                                 for d in streams]),
            ("t2_native", lambda _: [FP.parse_frame_flat(h, fg)
                                     for h in hdrs]),
            ("v2_args", lambda cols: dec._v2_args(fg, cols)),
            ("upload", upload),
            ("device_program", lambda u: u[0](*u[1:])),
            ("fetch", lambda p: (p.cpu(), layout)),
            ("write_frame", lambda p: dec._split_frames(
                [(h, fg.tiles) for h in hdrs], fg.geom, p))):
        val = step(val)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        laps[name] = (t1 - t0) * 1e3
        t0 = t1
    total_ms = sum(laps.values())
    return (" | ".join(f"{k} {v:.1f}" for k, v in laps.items())
            + f" | total {total_ms:.1f}; device program "
            f"{100 * laps['device_program'] / total_ms:.1f}% of it")


def _same(frame, src, depth):
    """The decoded gray or packed-RGB frame equals its source in the
    negotiated format (gray16le / rgb48le: samples << (16 - depth))."""
    want = src.astype(np.uint16) << (16 - depth) if depth > 8 else src
    got = frame.planes[0]
    return got.size == want.size and np.array_equal(
        got.reshape(want.shape), want)


def _need_launched(counts, names, what):
    missing = [k for k in names if counts[k] < 1]
    if missing:
        raise RuntimeError(f"{what}: {missing} never launched ({counts})")


def _batch_output(dec, streams):
    """The packed output of the program ``dec.decode_batch(streams)`` runs
    (the V3Program, else the BucketProgram on ``_v2_args``) in the
    identity layout, the tile-component samples that the wire pack takes
    (with the decoder's wire pack, that very program), on the card; that
    layout, the sample count the output holds and their bits."""
    hdrs = [parse_codestream(d, bitexact=dec.bitexact) for d in streams]
    fg = dec._fast_geom(hdrs[0])
    cols = [FP.parse_frame_flat(h, fg) for h in hdrs]
    layout = ASM.FrameLayout.identity(fg.geom.key(),
                                      wire_pack=dec._wp(fg.geom.cbps))
    n = len(streams) * fg.geom.total
    v3 = dec._v3_program(fg, cols, layout)
    if v3 is not None:
        prog, args = v3
        return prog(**args), layout, n, fg.geom.cbps
    geom, fin, _accum = dec._v2_args(fg, cols)
    return (dec._dispatch_args(geom, *fin, layout.replicate(len(streams))),
            layout, n, geom.cbps)


def _fetch_unpack(dec, streams, reps: int = 3):
    """Where the output of ``dec.decode_batch(streams)``'s program goes
    after the device: best-of-`reps` host-clock ms of the decoder's fetch
    (``_start_fetch``: a page-locked buffer, the copy, the wait), of the
    copy alone into a page-locked buffer reused across reps, and of the
    wire unpack (``unpack_words``; 0 without the pack); the bytes
    fetched."""
    packed, layout, n, cbps = _batch_output(dec, streams)
    torch.cuda.synchronize()
    fetch, copy, unpack = [], [], []
    pinned = torch.empty(packed.shape, dtype=packed.dtype,
                         pin_memory=packed.is_cuda)
    for _ in range(reps):
        t0 = time.perf_counter()
        host, _layout = dec._start_fetch(packed, layout)()
        t1 = time.perf_counter()
        pinned.copy_(packed)
        t2 = time.perf_counter()
        if packed.dtype == torch.int32:
            words = host.numpy().view(np.uint32)
            wirepack.unpack_words(words[:-1], cbps, n,
                                  out=np.empty(n + 1, np.uint16))
        t3 = time.perf_counter()
        fetch.append((t1 - t0) * 1e3)
        copy.append((t2 - t1) * 1e3)
        unpack.append((t3 - t2) * 1e3)
    return dict(fetch_ms=min(fetch), copy_ms=min(copy),
                unpack_ms=min(unpack), mb=packed.numel()
                * packed.element_size() / 1e6)


def _fmt_fetch(m):
    return (f"fetch {m['fetch_ms']:.1f} ms (copy alone {m['copy_ms']:.1f}) "
            f"of {m['mb']:.1f} MB, unpack {m['unpack_ms']:.1f} ms")


def _phase7(dev):
    """BASELINE config 4 (a crop) and the v2 path's other routes; returns
    (the refinement kernels' entries of the kernels line without their
    launches, the cleanup kernels' numbers at the v2 buckets, {path:
    (launch counts, frames)} of decode_stream and decode_batch)."""
    t0 = time.perf_counter()
    srcs, (A, B) = _c4_streams()
    print(f"phase 7 encode (port encoder): 2 grainy natural frames "
          f"{C4_W}x{C4_H} "
          f"10-bit gray 5/3, 1024x1024 tiles, 64x64 codeblocks and "
          f"precincts, 2 HT layers (BASELINE config 4, cut from 7680x4320),"
          f" {(len(A) + len(B)) / 2e6:.2f} MB/frame avg, "
          f"{time.perf_counter() - t0:.1f} s")

    dec = Decoder(device=dev)
    for name, data in (("A", A), ("B", B)):
        hdr = parse_codestream(data, bitexact=True)
        fg = dec._fast_geom(hdr)
        every, devl, n_host, n_deep = _zblk_hist(
            fg, FP.parse_frame_flat(hdr, fg))
        ndev = sum(devl.values())
        print(f"phase 7 frame {name}: {fg.ncblks} codeblocks, z_blk "
              f"histogram {every}; device lanes {ndev}, z_blk {devl}; "
              f"host-oracle lanes {n_host} ({n_deep} of them for maxbp > "
              f"25, the rest under 256 samples)")
        if n_deep:
            raise RuntimeError(f"frame {name}: lanes with maxbp > 25")
        if 2 * (devl[2] + devl[3]) < ndev:
            raise RuntimeError(f"frame {name}: fewer than half of the device "
                               "lanes carry refinement passes")

    # the kernels on the buckets of the main path's own program
    batch_in = [A, B, A, B]
    shapes, bargs, segs = _v2_buckets(dec, batch_in)
    clean, ref, info = _v2_kernel_checks(dev, shapes, bargs, segs)
    print(f"phase 7 decode_batch [A, B, A, B]'s program: {len(shapes)} "
          f"buckets ({sum(a['nreal'] for a in bargs)} device lanes; "
          f"{info['buckets']} refined buckets, {info['lanes']} lanes: "
          f"{', '.join(info['shapes'])})")
    _print_cleanup("phase 7", clean)
    for key, name in (("sigprop", "ht_sigprop_pass == sigprop_pass_ref "
                                  "(words)"),
                      ("magref", "ht_magref_pass == magref_pass_ref (same "
                                 "words)"),
                      ("pair", "refinement pair == refine_ref")):
        m = ref[key]
        print(f"phase 7   {name}: kernel {m['ms']:.4f} ms, plain "
              f"{m['plain_ms']:.1f} ms, bound {m['bound_ms']:.4f} ms "
              f"(bytes), {100 * m['bound_ms'] / m['ms']:.1f}% of bound; by "
              "bucket, ms (% of bound): " + ", ".join(
                  f"{t:.4f} ({100 * b / t:.1f}%)" for t, b in zip(
                      m["ms_by_bucket"], m["bound_ms_by_bucket"])))
    regs = _ptxas(build.load().log, ("ht_sigprop_kernel", "ht_magref_kernel"))
    print(f"phase 7   refinement pair {ref['pair']['ms']:.4f} ms "
          f"({ref['pair']['ms'] / len(batch_in):.4f} ms/frame) vs "
          f"{ONE_WARP_REFINE_MS} ms for the earlier one-warp-per-codeblock "
          "kernel; ptxas: " + "; ".join(f"{k}: {v}" for k, v in regs.items()))

    # the main paths
    _reset_counts()
    frames = list(dec.decode_stream([A, B]))
    stream_counts = _counts()
    _reset_counts()
    batch = dec.decode_batch(batch_in)
    batch_counts = _counts()
    if any(batch_counts[k] != info["buckets"] for k in _REFINE):
        raise RuntimeError(f"decode_batch launched the refinement "
                           f"{[batch_counts[k] for k in _REFINE]} times; its "
                           f"program has {info['buckets']} refined buckets")
    for fr, src in zip(frames + batch, srcs + srcs + srcs):
        if not _same(fr, src, 10):
            raise RuntimeError(f"c4 frame ({fr.fmt.name}) differs from its "
                               "source")
    if dec.v2_frames != 6 or dec.v3_frames or dec.host_frames:
        raise RuntimeError(f"c4: v2 frames {dec.v2_frames}, v3 "
                           f"{dec.v3_frames}, host {dec.host_frames}")
    on_path = ("ht_vlc_pass", "ht_magsgn_pass", *_REFINE)
    _need_launched(stream_counts, on_path, "c4 decode_stream")
    _need_launched(batch_counts, on_path, "c4 decode_batch")
    # the BucketProgram's coefficient stages and write-out: one
    # bucket_scatter, dwt_lift a level (no level under 8x8 here) and one
    # plane_writeframe a program call, no coef_mosaic
    want_s = [_v2_want(dec, [x]) for x in (A, B)]
    want = {"c4 decode_stream": {k: sum(w[k] for w in want_s)
                                 for k in _PROGRAM},
            "c4 decode_batch": {k: _v2_want(dec, batch_in)[k]
                                for k in _PROGRAM}}
    for (what, w), c in zip(want.items(), (stream_counts, batch_counts)):
        if {k: c[k] for k in _PROGRAM} != w or not w["bucket_scatter"] \
                or not w["dwt_lift"] or not w["plane_writeframe"]:
            raise RuntimeError(f"{what}: launches {c}, expected {w}")
    print(f"phase 7 decode_stream [A, B] and decode_batch [A, B, A, B]: "
          f"every frame == source ({frames[0].fmt.name}), all 6 via the "
          f"BucketProgram; launches {stream_counts} and {batch_counts}")
    times = {"decode_stream": [], "decode_batch": []}
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _fr in dec.decode_stream([A, B]):
            pass
        times["decode_stream"].append((time.perf_counter() - t0) * 500)
        t0 = time.perf_counter()
        dec.decode_batch(batch_in)
        times["decode_batch"].append((time.perf_counter() - t0) * 250)
    print("phase 7 ms/frame: " + "; ".join(
        f"{k} {', '.join(f'{t:.1f}' for t in v)}" for k, v in times.items()))
    print("phase 7 one batch of 4, ms: " + _laps_v2(dec, batch_in, dev))

    # the same batch with the wire pack, as bench.py's c4 runs it: the
    # pack runs once, at the end of the v2 BucketProgram
    dec_wp = Decoder(device=dev, wire_pack=True)
    _reset_counts()
    packed_batch = dec_wp.decode_batch(batch_in)
    wp_counts = _counts()
    if dec_wp.v2_frames != 4 or dec_wp.v3_frames or wp_counts["wire_pack"] \
            != 1 or any(not _same(fr, src, 10)
                        for fr, src in zip(packed_batch, srcs + srcs)):
        raise RuntimeError(f"c4 decode_batch with the wire pack: v2 frames "
                           f"{dec_wp.v2_frames}, launches {wp_counts}, or a "
                           "frame differs from its source")
    fu = {"plain": _fetch_unpack(dec, batch_in),
          "wire_pack": _fetch_unpack(dec_wp, batch_in)}
    print(f"phase 7 decode_batch [A, B, A, B] with wire_pack=True: every "
          f"frame == source, all 4 via the BucketProgram, launches "
          f"{wp_counts}; without the pack: {_fmt_fetch(fu['plain'])}; with "
          f"it: {_fmt_fetch(fu['wire_pack'])}")

    # the v2 path's other routes, on small streams
    rng = np.random.default_rng(4042)
    gray = _grainy(rng, 256, 256)
    rgb10 = _rgb(gray)
    rgb8 = (rgb10 >> 2).astype(np.uint8)
    s_rct = encode_frame_htj2k(rgb10, depth=10, mct=True, **SMALL_ENC)
    s_ict = encode_frame_htj2k(rgb8, pred=0, mct=True, **SMALL_ENC)
    s_vsc = encode_frame_htj2k(gray, depth=10, causal=True, **SMALL_ENC)
    s_gray = encode_frame_htj2k(gray, depth=10, **SMALL_ENC)
    v2_before = dec.v2_frames
    _reset_counts()
    if not _same(dec.decode(s_rct), rgb10, 10):
        raise RuntimeError("small RCT stream differs from its source")
    _need_launched(_counts(), on_path + ("rct_writeframe",), "small RCT")
    d_int = Decoder(device=dev, bitexact=True)
    d_flt = Decoder(device=dev, bitexact=False)
    _reset_counts()
    diffs = [_host_diff(d_int.decode(s_ict), s_ict, True),
             _host_diff(d_flt.decode(s_ict), s_ict, False)]
    _need_launched(_counts(), on_path + ("ict_writeframe",), "small ICT")
    if diffs[0][0] or diffs[1][0] > 1:
        raise RuntimeError(f"small ICT stream vs host oracles: {diffs}")
    if not _same(dec.decode(s_vsc), gray, 10):
        raise RuntimeError("VSC stream differs from its source")
    opts = []
    for kw in (dict(max_layers=1), dict(reduction_factor=1)):
        d = Decoder(device=dev, **kw)
        got = d.decode(s_gray).tobytes()
        want = host_decoder.decode_frame(s_gray, bitexact=True, **kw)
        if got != want.tobytes() or d.v2_frames != 1 or d.host_frames:
            raise RuntimeError(f"{kw}: differs from the host oracle or did "
                               f"not take the v2 path")
        opts.append(f"{kw} ({want.width}x{want.height})")
    if dec.v2_frames != v2_before + 2 or d_int.v2_frames != 1 \
            or d_flt.v2_frames != 1 \
            or dec.host_frames + d_int.host_frames + d_flt.host_frames:
        raise RuntimeError("small streams: not all on the v2 path")
    print(f"phase 7 small 256x256 streams on the v2 path: RGB 10-bit RCT == "
          f"source; RGB 8-bit 9/7+ICT integer == host oracle, float vs host "
          f"float oracle (max abs diff, samples off) {diffs[1]}; VSC (object "
          f"path) == source; {', '.join(opts)} == host oracle")

    pair = dict(ref["pair"], ms_per_frame=ref["pair"]["ms"] / len(batch_in))
    entries = [dict(name=name, route="cuda",
                    source="ffmpeg_ht_tpu_torch/csrc/ht_refine.cu",
                    replaces="ffmpeg_ht_tpu/ops/ht_refine.py:58",
                    **ref[key], ptxas={k: v for k, v in regs.items()
                                       if k.startswith(kernel)},
                    shapes="decode_batch [A, B, A, B]'s refined buckets, "
                           "summed", buckets=info["buckets"],
                    lanes=info["lanes"], refine_pair=pair)
               for name, key, kernel in (
                   ("ht_sigprop_pass", "sigprop", "ht_sigprop_kernel"),
                   ("ht_magref_pass", "magref", "ht_magref_kernel"))]
    paths = {"c4_decode_stream": (stream_counts, 2),
             "c4_decode_batch": (batch_counts, 4),
             "c4_decode_batch_wire_pack": (wp_counts, 4)}
    return entries, clean, paths, (srcs, [A, B])


def _phase8(dev, natural_src, natural_stream):
    """BASELINE config 5: four DCI-4K frames muxed into an MXF, demuxed and
    decoded with ``Decoder(bitexact=True, wire_pack=True)`` through
    ``decode_batch`` (one F=4 program) and ``decode_stream``, then by the
    CLI; the wire pack kernel against its plain version on that batch's
    own output. Returns (the kernels line's wire_pack entry without its
    launches, {path: (launch counts, frames)}, (the sources, the demuxed
    streams, the frames of the one-program ``decode_batch`` with the
    pack))."""
    t0 = time.perf_counter()
    plane = natural_src[:, :, 0]
    srcs = [natural_src] + [_rgb(np.roll(plane, k, 1)) for k in C5_ROLLS]
    seq = [natural_stream] + [encode_frame_htj2k(x, **ENC)
                              for x in srcs[1:]]
    enc_s = time.perf_counter() - t0
    os.makedirs(BUILD, exist_ok=True)
    path = os.path.join(BUILD, "c5_motion_htj2k.mxf")
    with open(path, "wb") as f:
        f.write(mux_mxf(seq, W, H, ncomp=3, depth=DEPTH))
    with open(path, "rb") as f:
        streams = list(demux_mxf(f.read()))
    if streams != seq:
        raise RuntimeError("MXF round trip changed the essence")
    print(f"phase 8 encode (port encoder): phase 3's natural frame and its "
          f"rolls by {', '.join(map(str, C5_ROLLS))} columns, {enc_s:.1f} s;"
          f" mux_mxf -> {os.path.getsize(path) / 1e6:.2f} MB "
          f"({os.path.relpath(path, os.path.dirname(BUILD))}); demux_mxf "
          f"gives back the {len(seq)} codestreams exactly")

    def same(frames):
        return len(frames) == len(srcs) and all(
            fr.fmt.name == "rgb48le" and np.array_equal(
                fr.planes[0].reshape(H, W, 3),
                src.astype(np.uint16) << (16 - DEPTH))
            for fr, src in zip(frames, srcs))

    dec = Decoder(device="cuda", bitexact=True, wire_pack=True)
    plain_dec = Decoder(device="cuda", bitexact=True)
    F = len(streams)
    _reset_counts()
    frames = dec.decode_batch(streams)
    batch_counts = _counts()
    _reset_counts()
    stream_frames = list(dec.decode_stream(streams))
    stream_counts = _counts()
    _reset_counts()
    plain_frames = plain_dec.decode_batch(streams)
    plain_counts = _counts()
    if not same(frames) or not same(stream_frames):
        raise RuntimeError("c5 frame differs from its source")
    if [a.tobytes() for a in plain_frames] != [a.tobytes() for a in frames]:
        raise RuntimeError("c5 decode_batch: wire_pack=False gives other "
                           "bytes")
    if dec.v3_frames != 2 * F or plain_dec.v3_frames != F \
            or dec.host_frames + plain_dec.host_frames \
            or batch_counts["wire_pack"] != 1 \
            or stream_counts["wire_pack"] != F \
            or plain_counts["wire_pack"] != 0:
        raise RuntimeError(f"c5: v3 frames {dec.v3_frames} and "
                           f"{plain_dec.v3_frames}, launches {batch_counts}, "
                           f"{stream_counts}, {plain_counts}")
    on_path = ("ht_vlc_pass", "ht_magsgn_pass", "rct_writeframe", "wire_pack",
               "coef_mosaic", "dwt_lift")
    _need_launched(batch_counts, on_path, "c5 decode_batch")
    _need_launched(stream_counts, on_path, "c5 decode_stream")
    print(f"phase 8 decode_batch (one program, F={F}) and decode_stream with "
          f"wire_pack=True: every frame == source (rgb48le, << "
          f"{16 - DEPTH}), all via the v3 device program, launches "
          f"{batch_counts} and {stream_counts}; decode_batch with "
          f"wire_pack=False gives the same bytes (launches {plain_counts})")

    # the kernel against its plain version on the batch's own int16 output,
    # then on runs of its samples at the sizes of one c5 frame (the
    # decode_stream launch) and of the c4 batch with the pack (phase 7).
    # A smaller size is timed on the batch's consecutive runs in turn, so
    # that no launch reads an input the one before left in the 50 MB L2
    packed16, _layout, n, _cbps = _batch_output(plain_dec, streams)
    if int(packed16[-1]) != 1:
        raise RuntimeError("c5 decode_batch: the ok flag is clear")
    sizes = {}
    for size, k in (("c5 batch", n), ("one c5 frame", n // F),
                    ("c4 batch", 4 * C4_W * C4_H)):
        # run j: k samples, then the next one as the flag
        runs = [packed16[j * k:(j + 1) * k + 1] for j in range(n // k)]
        buf = runs[0]
        words = wirepack.pack_words(buf, DEPTH)
        ref, plain_ms = _plain(wirepack.pack_words_ref, buf[:k], DEPTH)
        err = max(int((words[:-1].to(torch.int64) - ref.to(torch.int64))
                      .abs().max()), abs(int(words[-1]) - int(buf[-1])))
        if err:
            raise RuntimeError(f"wire_pack differs from pack_words_ref at "
                               f"the {size} size (max abs err {err})")
        turn = itertools.cycle(runs)
        ms = _cuda_ms(lambda: wirepack.pack_words(next(turn), DEPTH), 20,
                      True)
        nbytes = buf.numel() * 2 + words.numel() * 4
        bound = _bound(nbytes)
        # the card's streaming rate on this many bytes: a copy of the
        # input (a yardstick, not a call that computes the pack)
        dup = torch.empty_like(buf)
        copy_ms = _cuda_ms(lambda: dup.copy_(next(turn)), 20, True)
        sizes[f"n_{k}"] = dict(samples=k, input_runs=len(runs),
                               max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               bound_ms=bound, input_copy_ms=copy_ms)
        print(f"phase 8   wire_pack == pack_words_ref (+ flag word) at the "
              f"{size} size, {k} samples ({buf.numel() * 2 / 1e6:.1f} MB "
              f"in, {words.numel() * 4 / 1e6:.1f} MB out): kernel {ms:.4f} "
              f"ms ({nbytes / ms / 1e9:.2f} TB/s, {len(runs)} input runs "
              f"in turn), plain {plain_ms:.1f} ms, bound {bound:.4f} ms "
              f"(bytes), {100 * bound / ms:.1f}% of bound; a copy_ of the "
              f"input {copy_ms:.4f} ms "
              f"({2 * buf.numel() * 2 / copy_ms / 1e9:.2f} TB/s)")
        del words, ref, dup, runs, turn
    del packed16, buf
    regs = {k: v for k, v in _ptxas(build.load().log,
                                    ("wire_pack_kernel",)).items()
            if k.endswith(f"<{DEPTH}>")}
    print(f"phase 8   wire_pack c5 batch {sizes[f'n_{n}']['ms']:.4f}"
          f" ms vs {ONE_THREAD_WIRE_PACK_MS} ms for the earlier "
          "one-thread-per-group kernel; ptxas: "
          + "; ".join(f"{k}: {v}" for k, v in regs.items()))

    fu = {"plain": _fetch_unpack(plain_dec, streams),
          "wire_pack": _fetch_unpack(dec, streams)}
    times = {"plain": [], "wire_pack": []}
    for _ in range(REPS):
        for key, d in (("plain", plain_dec), ("wire_pack", dec)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d.decode_batch(streams)
            times[key].append((time.perf_counter() - t0) * 1e3 / F)
    res = dec.bench_resident(streams, n_it=5, reps=3)
    if res["frames_merged"] != F:
        raise RuntimeError(f"bench_resident: {res}")
    print(f"phase 8 without the pack: {_fmt_fetch(fu['plain'])}; with it: "
          f"{_fmt_fetch(fu['wire_pack'])}; decode_batch ms/frame "
          + "; ".join(f"{k} {', '.join(f'{t:.1f}' for t in v)}"
                      for k, v in times.items())
          + f"; bench_resident F={F}: {res['ms_per_frame']:.3f} ms/frame")

    # the CLI on the MXF file
    md5_path = os.path.join(BUILD, "c5_motion_htj2k.framemd5")
    err_buf = io.StringIO()
    with contextlib.redirect_stderr(err_buf):
        rc = cli.main(["decode", path, "-f", "framemd5", "-o", md5_path,
                       "--benchmark", "--device", "cuda"])
    with open(md5_path) as f:
        got = f.read()
    fmt = frames[0].fmt
    want = mux.framemd5([
        host_decoder.DecodedFrame(fmt=fmt, width=W, height=H, planes=[
            (src.astype(np.uint16) << (16 - DEPTH)).reshape(H, 3 * W)])
        for src in srcs])
    bench = [ln for ln in err_buf.getvalue().splitlines()
             if ln.startswith("bench:")]
    if rc != 0 or got != want or len(bench) != 2:
        raise RuntimeError(f"CLI decode of the MXF: rc {rc}, framemd5 "
                           f"{'equal' if got == want else 'differs'}, "
                           f"{err_buf.getvalue()[-2000:]}")
    print(f"phase 8 cli decode {os.path.basename(path)} -f framemd5 "
          f"--benchmark --device cuda: framemd5 == the sources' ({F} "
          f"frames); " + " | ".join(bench))

    # the entry's numbers are the c5 batch's; its error covers every size
    err = max(v["max_abs_err"] for v in sizes.values())
    c5 = dict(sizes.pop(f"n_{n}"), max_abs_err=err)
    entry = dict(name="wire_pack", route="cuda",
                 source="ffmpeg_ht_tpu_torch/csrc/wire_pack.cu",
                 replaces="ffmpeg_ht_tpu/ops/wirepack.py:33",
                 **c5, ptxas=regs, other_sizes=sizes, fetch_unpack=fu,
                 decode_batch_ms_per_frame=times,
                 bench_resident_ms_per_frame=res["ms_per_frame"])
    paths = {"c5_decode_batch": (batch_counts, F),
             "c5_decode_stream": (stream_counts, F)}
    return entry, paths, (srcs, streams, frames)


class _Keep(logging.Handler):
    """A logging handler that keeps the messages it is given."""

    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _phase9(dev, c5_data, c4_data, single_ms):
    """``decode_batch(devices=...)``: phase 8's four c5 streams sharded over
    the card listed 2 and 3 times (F = 4 over D = 3 pads two frames), with
    and without the pack; the cleanup kernels and RCT against their plain
    versions on one shard's own program and lanes; phase 7's refined c4
    streams, which cannot shard. Returns (the shard's kernel checks,
    {path: (launch counts, frames)})."""
    srcs, streams, single = c5_data
    F, want = len(streams), [fr.tobytes() for fr in single]
    med = {k: statistics.median(v) for k, v in single_ms.items()}
    paths = {}
    for D in (2, 3):
        devices = [dev] * D
        Fl = -(-F // D)
        for wp in (False, True):
            dec = Decoder(device=dev, bitexact=True, wire_pack=wp)
            _reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frames = dec.decode_batch(streams, devices=devices,
                                      require_shard=True)
            ms = (time.perf_counter() - t0) * 1e3 / F
            counts = _counts()
            if [fr.tobytes() for fr in frames] != want or not all(
                    _same(fr, src, DEPTH) for fr, src in zip(frames, srcs)):
                raise RuntimeError(f"c5 over {D} shards (wire_pack={wp}): a "
                                   "frame differs from phase 8's or its "
                                   "source")
            # per shard: the cleanup pair once, RCT once a frame of its Fl
            # (pads included), the pack once
            expect = {"ht_vlc_pass": D, "ht_magsgn_pass": D,
                      "rct_writeframe": D * Fl, "ict_writeframe": 0,
                      **dict.fromkeys(_REFINE, 0), "wire_pack": D if wp else 0,
                      **_lift_want(dec, streams[0], Fl, D)}
            if counts != expect or dec.v3_frames != F or dec.v2_frames \
                    or dec.host_frames:
                raise RuntimeError(f"c5 over {D} shards (wire_pack={wp}): "
                                   f"launches {counts}, expected {expect}; "
                                   f"v3 frames {dec.v3_frames}")
            key = "wire_pack" if wp else "plain"
            paths[f"c5_sharded_d{D}_{key}"] = (counts, F)
            print(f"phase 9 decode_batch(devices=[{dev}] * {D}, "
                  f"require_shard=True, wire_pack={wp}): {F} frames == "
                  f"phase 8's single program, byte for byte, and == source; "
                  f"{D} shards of {Fl} frames ({D * Fl - F} pad), launches "
                  f"{counts}; {ms:.1f} ms/frame against {med[key]:.1f} "
                  "single-device (phase 8 median). One card listed D times: "
                  "no scaling can be read here")

    # the kernels on shard 0's own program and lanes
    dec = Decoder(device=dev)
    plan, why = dec._shard_plan(streams, 2)
    if plan is None:
        raise RuntimeError(f"c5 batch cannot shard: {why}")
    hdrs, fg, frames, Fl, msc = plan
    prog, args = dec._v3_shard(fg, frames[:Fl], msc, dev,
                               dec._layout(hdrs, fg.geom))
    clean = _cleanup_check(args, _v3_segments(frames[:Fl]), prog.qw, prog.qh,
                           msc)
    ln = clean["lanes"]
    print(f"phase 9 shard 0 of 2: its V3Program (F={prog.frames}, ms_class "
          f"{msc}) on {ln['N']} lanes (W ms/mel/vlc = "
          f"{'/'.join(map(str, ln['W']))})")
    _print_cleanup("phase 9", clean)
    outs, _ok = prog.decode_planes(**args)
    clean["rct"] = _rct_check(prog, outs)
    r = clean["rct"]
    print(f"phase 9   rct kernel == rct_writeframe_ref in the "
          f"{prog.frame_layout.fmt.name} layout on shard 0's "
          f"first frame: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} "
          f"ms, bound {r['bound_ms']:.4f} ms (bytes), "
          f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound")
    del outs, args

    # phase 7's refined streams: no v3 frame, so no shard
    c4_srcs, c4_streams = c4_data
    dec = Decoder(device=dev)
    try:
        dec.decode_batch(c4_streams, devices=[dev] * 2, require_shard=True)
    except UnshardableBatch as e:
        reason = str(e)
    else:
        raise RuntimeError("c4 refined streams: decode_batch sharded them")
    keep = _Keep()
    log = logging.getLogger("ffmpeg_ht_tpu_torch")
    log.addHandler(keep)
    try:
        frames = dec.decode_batch(c4_streams, devices=[dev] * 2)
    finally:
        log.removeHandler(keep)
    if not any("cannot shard" in m for m in keep.messages) or not all(
            _same(fr, src, 10) for fr, src in zip(frames, c4_srcs)) \
            or dec.v2_frames != len(c4_streams):
        raise RuntimeError(f"c4 without require_shard: {keep.messages}, v2 "
                           f"frames {dec.v2_frames}, or a frame differs")
    print(f"phase 9 c4 refined streams with require_shard=True: "
          f"UnshardableBatch({reason!r}); without it: logged \"cannot "
          f"shard\", {len(frames)} frames == source on one device (v2)")
    return clean, paths


# ---- phase 10: the conformance corpus (a copy of the one in
# tests/test_torch_conformance.py, which pins it; nothing of tests/ is
# imported here)

# `launches` counts, in this order, the HT cleanup pair (one VLC and one
# MagSgn launch each), the refinement pair (SigProp then MagRef), RCT,
# ICT, the wire pack, coef_mosaic, dwt_lift (a launch a DWT level of at
# least 8x8), dwt_small (a launch for the levels under 8x8),
# bucket_scatter and plane_writeframe
KERNEL_GROUPS = ("cleanup", "refine", "rct", "ict", "wire_pack", "coef",
                 "lift", "small", "scatter", "write")
_GROUP_COUNTERS = {"cleanup": ("ht_vlc_pass", "ht_magsgn_pass"),
                   "refine": _REFINE, "rct": ("rct_writeframe",),
                   "ict": ("ict_writeframe",), "wire_pack": ("wire_pack",),
                   "coef": ("coef_mosaic",), "lift": ("dwt_lift",),
                   "small": ("dwt_small",), "scatter": ("bucket_scatter",),
                   "write": ("plane_writeframe",)}
ROUTES = {"v3": (1, 0, 0), "v2": (0, 1, 0), "host": (0, 0, 1)}
_ROUTE_NAMES = {v: k for k, v in ROUTES.items()}
POC = [(0, 0, 2, 2, 1, "lrcp"), (2, 0, 2, 33, 1, "rlcp")]
SMALL = dict(nreslevels=3, log2_cblk_width=5, log2_cblk_height=5)
# the one batch: three frames of the PPT stream's geometry
BATCH_SEEDS = (31, 32, 33)
# bit flips per mutant base
FLIPS = 64
REF_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                       "ref")

_Case = collections.namedtuple(
    "_Case", "name kind img enc dec route launches lossless golden")


def _noise(seed, shape, hi=256, dtype=np.uint8):
    return np.random.default_rng(seed).integers(0, hi, shape, dtype=dtype)


def _lowamp(seed, h, w, amp):
    """Low-amplitude content around mid-scale (an all-background ROI
    shift stays lossless on it)."""
    rng = np.random.default_rng(seed)
    return (128 + rng.integers(-amp, amp + 1, (h, w))).astype(np.uint8)


def _fate_corpus():
    """The FATE streams (tests/test_fate.py:_corpus(), seed 20260816):
    (name, kind, image, encoder options); their golden framecrc is
    tests/ref/fate-<name>."""
    rng = np.random.default_rng(20260816)
    xx, yy = np.meshgrid(np.arange(96), np.arange(80))
    smooth = ((xx + yy) * 255 // 176).astype(np.uint8)
    return [
        ("ht-gray-64", "ht", rng.integers(0, 256, (64, 64), np.uint8), {}),
        ("ht-gray-odd", "ht",
         rng.integers(0, 256, (53, 67), np.uint8), {}),
        ("ht-rgb", "ht", rng.integers(0, 256, (48, 56, 3), np.uint8), {}),
        ("ht-16bit", "ht",
         rng.integers(0, 65536, (40, 40)).astype(np.uint16), {}),
        ("ht-smooth", "ht", smooth, {}),
        ("ht-3pass", "ht", rng.integers(0, 256, (64, 64), np.uint8),
         {"refinement": True}),
        ("ht-tiled", "ht", rng.integers(0, 256, (150, 140), np.uint8),
         {"tile_width": 64, "tile_height": 64}),
        ("j2k-53", "t800", rng.integers(0, 256, (64, 64), np.uint8),
         {"pred": 1}),
        ("j2k-97int", "t800", rng.integers(0, 256, (64, 64), np.uint8),
         {"pred": 0}),
        ("j2k-layers", "t800", rng.integers(0, 256, (64, 64), np.uint8),
         {"pred": 0, "layer_rates": [8, 4, 2]}),
    ]


def _conformance_corpus():
    """[_Case]: the FATE streams, then the tail. `route` is the route a
    CPU run of the port takes, `launches` the kernel launches of one
    decode by KERNEL_GROUPS (on the CPU, the calls of their plain
    versions), `lossless` whether the frame must equal its source."""
    # the FATE streams' routes and launches by KERNELS
    fate = {
        "ht-gray-64": ("v3", (1, 0, 0, 0, 0, 1, 4, 1, 0, 1)),
        "ht-gray-odd": ("v3", (1, 0, 0, 0, 0, 1, 3, 1, 0, 1)),
        "ht-rgb": ("v3", (1, 0, 0, 0, 0, 1, 3, 1, 0, 1)),
        "ht-16bit": ("v3", (1, 0, 0, 0, 0, 1, 3, 1, 0, 1)),
        "ht-smooth": ("v3", (1, 0, 0, 0, 0, 1, 4, 1, 0, 1)),
        "ht-3pass": ("v2", (2, 2, 0, 0, 0, 0, 4, 1, 1, 1)),
        "ht-tiled": ("v3", (1, 0, 0, 0, 0, 1, 4, 1, 0, 1)),
        "j2k-53": ("host", (0, 0, 0, 0, 0, 0, 0, 0, 0, 0)),
        "j2k-97int": ("host", (0, 0, 0, 0, 0, 0, 0, 0, 0, 0)),
        "j2k-layers": ("host", (0, 0, 0, 0, 0, 0, 0, 0, 0, 0)),
    }
    cases = [_Case(name, kind, img, opts, {}, *fate[name],
                  opts.get("pred", 1) == 1, True)
             for name, kind, img, opts in _fate_corpus()]
    rgb3 = [_noise(10 + i, (80, 112)) for i in range(3)]
    signed = np.random.default_rng(18).integers(-512, 512, (128, 128),
                                                dtype=np.int16)
    for name, img, enc, dec, route, launches, lossless in (
            ("ppt", _noise(1, (96, 128)), dict(ppt=True), {}, "v3",
             (1, 0, 0, 0, 0, 1, 4, 1, 0, 1), True),
            ("ppt-multitile-layers-eph", _noise(2, (80, 112, 3)),
             dict(tile_width=64, tile_height=64, ppt=True, eph=True,
                  refinement=True, ht_layers=2), {}, "v2",
             (2, 2, 0, 0, 0, 0, 4, 1, 1, 1), True),
            ("ppt-sop", _noise(3, (96, 128)),
             dict(ppt=True, sop=True, eph=True), {}, "v3",
             (1, 0, 0, 0, 0, 1, 4, 1, 0, 1), True),
            ("ppt-tile-parts", _noise(4, (96, 128)),
             dict(ppt=True, tp_interval=3), {}, "v3",
             (1, 0, 0, 0, 0, 1, 4, 1, 0, 1), True),
            ("ppm", _noise(5, (96, 128)), dict(ppm=True), {}, "v3",
             (1, 0, 0, 0, 0, 1, 4, 1, 0, 1), True),
            ("ppm-multitile", _noise(6, (80, 112, 3)),
             dict(tile_width=48, tile_height=48, ppm=True), {}, "v2",
             (1, 0, 0, 0, 0, 0, 3, 1, 1, 1), True),
            ("ppt-poc-layers", _noise(7, (96, 128)),
             dict(ppt=True, refinement=True, ht_layers=2, nreslevels=4,
                  poc=POC), {}, "v2", (2, 2, 0, 0, 0, 0, 3, 0, 1, 1), True),
            ("precincts", _noise(8, (96, 128)), dict(log2_prec_width=6), {},
             "v3", (1, 0, 0, 0, 0, 1, 4, 1, 0, 1), True),
            ("rpcl-layers-precincts", _noise(9, (96, 128)),
             dict(refinement=True, ht_layers=2, log2_prec_width=6,
                  prog="rpcl"), {}, "v2",
             (2, 2, 0, 0, 0, 0, 4, 1, 1, 1), True),
            ("rgb-layers-multitile", rgb3,
             dict(chroma_shift=(0, 0), refinement=True, ht_layers=2,
                  tile_width=64, tile_height=64, log2_prec_width=5), {},
             "v2", (2, 2, 0, 0, 0, 0, 4, 1, 1, 1), True),
            ("plhd-3layer", _noise(13, (96, 128)),
             dict(refinement=True, ht_layers=3), {}, "v2",
             (2, 2, 0, 0, 0, 0, 4, 1, 1, 1),
             True),
            ("plhd-single-16", _noise(14, (96, 128)),
             dict(refinement=True, ht_plhd_single=True), {}, "v2",
             (2, 2, 0, 0, 0, 0, 4, 1, 1, 1), True),
            # 8x8 codeblocks are under the host area: every lane decodes
            # on the host inside the fast lane, and no entropy kernel
            # launches; the flat buffer is the prefill alone (no bucket
            # launch), then the DWT and the write-out
            ("plhd-single-8", _noise(14, (96, 128)),
             dict(refinement=True, ht_plhd_single=True, log2_cblk_width=3,
                  log2_cblk_height=3), {}, "v2",
             (0, 0, 0, 0, 0, 0, 4, 1, 0, 1), True),
            ("lowres-r1", _noise(15, (96, 128)), dict(nreslevels=5),
             dict(reduction_factor=1), "v3",
             (1, 0, 0, 0, 0, 1, 3, 0, 0, 1), False),
            ("lowres-r2", _noise(15, (96, 128)), dict(nreslevels=5),
             dict(reduction_factor=2), "v3",
             (1, 0, 0, 0, 0, 1, 2, 0, 0, 1), False),
            ("lowres-rgb-multitile-prec", _noise(16, (80, 112, 3)),
             dict(tile_width=64, tile_height=64, nreslevels=4,
                  log2_prec_width=5, mct=True), dict(reduction_factor=1),
             "v3", (1, 0, 4, 0, 0, 1, 2, 1, 0, 0), False),
            ("lowres-layers-poc", _noise(17, (96, 128)),
             dict(nreslevels=4, refinement=True, ht_layers=2, poc=POC),
             dict(reduction_factor=1), "v2",
             (2, 2, 0, 0, 0, 0, 2, 0, 1, 1), False),
            ("signed-10bit", signed,
             dict(depth=10, sgnd=True, tile_width=128, tile_height=128,
                  log2_cblk_width=6, log2_cblk_height=6), {}, "v3",
             (1, 0, 0, 0, 0, 1, 5, 1, 0, 1), True),
            ("roi", _lowamp(19, 128, 128, 7),
             dict(roi_shift=9, tile_width=128, tile_height=128,
                  log2_cblk_width=6, log2_cblk_height=6), {}, "host",
             (0, 0, 0, 0, 0, 0, 0, 0, 0, 0), True),
            ("ht-mixed", _noise(20, (64, 80)), dict(ht_mixed=True), {},
             "host", (0, 0, 0, 0, 0, 0, 0, 0, 0, 0), True),
            ("max-layers-1", _noise(21, (96, 128)),
             dict(refinement=True, ht_layers=2), dict(max_layers=1), "v2",
             (2, 0, 0, 0, 0, 0, 4, 1, 1, 1), False),
            ("cblk-128x32", _noise(22, (96, 128)),
             dict(log2_cblk_width=7, log2_cblk_height=5), {}, "host",
             (0, 0, 0, 0, 0, 0, 0, 0, 0, 0), True),
            ("rct-rgb10", _noise(23, (96, 128, 3), 1024, np.uint16),
             dict(depth=10, mct=True, **SMALL), {}, "v3",
             (1, 0, 1, 0, 0, 1, 2, 0, 0, 0),
             True),
            ("ict-int", _noise(24, (96, 128, 3)),
             dict(pred=0, mct=True, **SMALL), dict(bitexact=True), "v3",
             (1, 0, 0, 1, 0, 1, 2, 0, 0, 0), False),
            ("ict-float", _noise(24, (96, 128, 3)),
             dict(pred=0, mct=True, **SMALL), dict(bitexact=False), "v3",
             (1, 0, 0, 1, 0, 1, 2, 0, 0, 0), False),
            ("wire-pack-12", _noise(25, (96, 128), 4096, np.uint16),
             dict(depth=12, **SMALL), dict(wire_pack=True), "v3",
             (1, 0, 0, 0, 1, 1, 2, 0, 0, 1), True)):
        cases.append(_Case(name, "ht", img, enc, dec, route, launches,
                           lossless, False))
    return cases


def _batch_images(shape):
    """Three seeded noise frames whose lower half is flat: the codeblocks
    there code no pass, so their lanes are inert (qws = qhs = 0)."""
    imgs = []
    for seed in BATCH_SEEDS:
        img = _noise(seed, shape)
        img[shape[0] // 2:] = seed
        imgs.append(img)
    return imgs


def _mutants():
    """({base name: stream}, [(base name, byte position, bit mask)]): the
    64x64 ``np.arange`` stream (flips seeded 7; the v3 program) and a
    refined two-layer 96x128 stream (flips seeded 8; the v2 program with
    SigProp / MagRef), FLIPS flips each."""
    bases = {
        "arange64": (np.arange(4096, dtype=np.uint8).reshape(64, 64), {},
                     7),
        "refined96x128": (np.random.default_rng(20261019).integers(
            0, 256, (96, 128), dtype=np.uint8),
            dict(refinement=True, ht_layers=2), 8)}
    streams = {name: encode_frame_htj2k(img, **enc)
               for name, (img, enc, _seed) in bases.items()}
    muts = []
    for name, (_img, _enc, seed) in bases.items():
        rng = np.random.default_rng(seed)
        for _ in range(FLIPS):
            pos = int(rng.integers(0, len(streams[name])))
            muts.append((name, pos, 1 << int(rng.integers(0, 8))))
    return streams, muts


def _encode_case(case):
    fn = encode_frame_htj2k if case.kind == "ht" else encode_frame_t800
    return fn(case.img, **case.enc)


def _host_options(case):
    return dict(bitexact=case.dec.get("bitexact", True),
                reduction_factor=case.dec.get("reduction_factor", 0),
                max_layers=case.dec.get("max_layers", 0))


def _source_bytes(case):
    """A lossless case's source in the negotiated pixel format: planes
    interleaved, signed samples offset to unsigned, 9..15-bit samples
    shifted to the top of 16 bits."""
    img = case.img
    if isinstance(img, list):
        img = np.stack(img, -1)
    depth = case.enc.get("depth", img.dtype.itemsize * 8)
    x = img.astype(np.int64)
    if case.enc.get("sgnd"):
        x = x + (1 << (depth - 1))
    if depth <= 8:
        return x.astype(np.uint8).tobytes()
    return (x << (16 - depth)).astype(np.uint16).tobytes()


def _expected_counts(launches):
    """{kernel counter: launches} for a case's `launches`."""
    out = dict.fromkeys(_KERNELS, 0)
    for group, n in zip(KERNEL_GROUPS, launches):
        for k in _GROUP_COUNTERS[group]:
            out[k] = n
    return out


def _delta(before, after):
    return {k: after[k] - before[k] for k in after}


def _frame_problems(case, data, frame):
    """What is wrong with a corpus stream's decoded frame: against the
    port's host oracle (within 1 LSB for float 9/7), its golden framecrc
    and its source; [] when nothing is."""
    want = host_decoder.decode_frame(data, **_host_options(case))
    bad = []
    if frame.fmt.name != want.fmt.name or (frame.width, frame.height) \
            != (want.width, want.height):
        return [f"{frame.fmt.name} {frame.width}x{frame.height} != host "
                f"{want.fmt.name} {want.width}x{want.height}"]
    if case.dec.get("bitexact", True):
        if frame.tobytes() != want.tobytes():
            bad.append("differs from the host oracle")
    else:
        d, n = _host_diff(frame, data, False)
        if d > 1:
            bad.append(f"{n} samples off the host float oracle, max {d}")
    if case.lossless and frame.tobytes() != _source_bytes(case):
        bad.append("differs from its source")
    if case.golden:
        with open(os.path.join(REF_DIR, f"fate-{case.name}")) as f:
            if mux.framecrc([frame]) != f.read():
                bad.append("framecrc differs from its golden")
    return bad


def _stream_lanes(dec, data):
    """The lanes of the device program ``dec.decode(data)`` runs: ("v3",
    its V3Program, the program's arguments on the card, the decoded lanes'
    (lcup, pcup)), ("v2", shapes, bucket arrays, per-bucket segments, the
    BucketProgram, its arguments on the card) for the fast lane's or the
    object path's BucketProgram, or None."""
    hdr = dec._parse(data)
    if not dec.max_layers and FP.fast_profile(hdr):
        fg = dec._fast_geom(hdr)
        cols = FP.parse_frame_flat(hdr, fg)
        if cols is not None:
            v3 = dec._v3_program(fg, [cols], dec._layout([hdr], fg.geom))
            if v3 is not None:
                return ("v3", *v3,
                        _v3_segments([FP.build_v3_frame(fg, cols)]))
            return ("v2", *_v2_buckets(dec, [data]),
                    *_v2_program(dec, [data], dec.device))
    tiles = dec._parse_tiles(hdr)
    if not DEC._supported_on_device(hdr, tiles):
        return None
    return _object_buckets(dec, data)


def _outcome(decode):
    """("frame", width, height, bytes) of decode(), or ("J2KError",)."""
    try:
        frame = decode()
    except J2KError:
        return ("J2KError",)
    return ("frame", frame.width, frame.height, frame.tobytes())


def _phase10(dev):
    """The conformance corpus through ``Decoder(device="cuda")``: every
    stream's frame against the host oracle, its golden framecrc or its
    source, its route and launches against the expected ones; the
    kernels against their plain versions on every device stream's lanes;
    one ``decode_batch`` of three frames; the bit-flip mutants against
    the host oracle. Returns ({kernel: max abs error in this phase},
    {path: (launch counts, frames)})."""
    t_phase = time.perf_counter()
    corpus = _conformance_corpus()
    streams = [_encode_case(c) for c in corpus]
    print(f"phase 10 encode (port encoder): {len(corpus)} conformance "
          f"streams ({sum(c.golden for c in corpus)} FATE), "
          f"{sum(map(len, streams)) / 1e3:.1f} kB, "
          f"{time.perf_counter() - t_phase:.1f} s")
    problems, routes = [], collections.Counter()

    # the main path: one decoder a stream, as a user would open it
    decoders = [Decoder(device=dev, **c.dec) for c in corpus]
    _reset_counts()
    frames = []
    for case, data, dec in zip(corpus, streams, decoders):
        before = _counts()
        frames.append(dec.decode(data))
        got = _delta(before, _counts())
        route = (dec.v3_frames, dec.v2_frames, dec.host_frames)
        routes[_ROUTE_NAMES.get(route, str(route))] += 1
        if route != ROUTES[case.route]:
            problems.append(f"{case.name}: route (v3, v2, host) {route}, "
                            f"expected {ROUTES[case.route]}")
        want = _expected_counts(case.launches)
        if got != want:
            problems.append(f"{case.name}: launches {got}, expected "
                            f"{want}")
    counts = _counts()
    for case, data, frame in zip(corpus, streams, frames):
        problems += [f"{case.name}: {p}"
                     for p in _frame_problems(case, data, frame)]

    # the kernels against their plain versions on every device stream's
    # lanes (these launches are not the main path's)
    errs = dict.fromkeys(("vlc", "magsgn", "pair", "sigprop", "magref",
                          "refine_pair", "rct", "ict", "wire_pack",
                          *_PROGRAM), 0)
    lanes = collections.Counter()
    for case, data, dec in zip(corpus, streams, decoders):
        if case.route == "host":
            continue
        sl = _stream_lanes(dec, data)
        if sl[0] == "v3":
            _kind, prog, args, segs = sl
            c = _cleanup_check(args, segs, prog.qw, prog.qh, prog.ms_class)
            lanes["v3"] += c["lanes"]["N"]
            checks = [_program_check(prog, args, 1)]
            if prog.band_direct:
                lanes["band-direct v3"] += c["lanes"]["N"]
                checks.append(_lift_check(prog, args))
            for m in checks:
                for k, v in m.items():
                    errs[k] = max(errs[k], v["max_abs_err"])
            if case.launches[2]:
                outs, _ok = prog.decode_planes(**args)
                errs["rct"] = max(errs["rct"],
                                  _rct_check(prog, outs)["max_abs_err"])
                del outs
        else:
            _kind, shapes, bargs, segs, prog, args = sl
            c, ref, info = _v2_kernel_checks(dev, shapes, bargs, segs)
            for k, v in _program_check(prog, args, 1).items():
                errs[k] = max(errs[k], v["max_abs_err"])
            lanes["v2"] += sum(a["nreal"] for a in bargs)
            lanes["refined buckets"] += info["buckets"]
            for k, key in (("sigprop", "sigprop"), ("magref", "magref"),
                           ("refine_pair", "pair")):
                errs[k] = max(errs[k], ref[key]["max_abs_err"])
        for k in ("vlc", "magsgn", "pair"):
            errs[k] = max(errs[k], c[k]["max_abs_err"])
        if case.launches[3]:
            transform = DWT97_INT if dec.bitexact else DWT97
            nums = _ict_check(dec, [data], transform)[0]
            errs["ict"] = max(errs["ict"], nums["max_abs_err"])
        if case.launches[4]:
            packed16, _layout, n, cbps = _batch_output(
                Decoder(device=dev, bitexact=dec.bitexact), [data])
            words = wirepack.pack_words(packed16, cbps)
            ref = wirepack.pack_words_ref(packed16[:n], cbps)
            errs["wire_pack"] = max(
                errs["wire_pack"],
                int((words[:-1].to(torch.int64)
                     - ref.to(torch.int64)).abs().max()),
                abs(int(words[-1]) - int(packed16[-1])))
    print(f"phase 10 kernels == their plain versions on the device "
          f"streams' lanes ({dict(lanes)}), max abs err: {errs}")

    # one batch: three frames of the PPT geometry in one V3Program whose
    # lanes include inert ones, against the three single decodes
    ppt = next(c for c in corpus if c.name == "ppt")
    batch = [_encode_case(ppt._replace(img=img))
             for img in _batch_images(ppt.img.shape)]
    dec = Decoder(device=dev)
    hdrs = [dec._parse(d) for d in batch]
    fg = dec._fast_geom(hdrs[0])
    cols = [FP.parse_frame_flat(h, fg) for h in hdrs]
    prog, args = dec._v3_program(fg, cols, dec._layout(hdrs, fg.geom))
    inert = int((args["qws"] == 0).sum())
    c = _cleanup_check(args, _v3_segments([FP.build_v3_frame(fg, x)
                                           for x in cols]),
                       prog.qw, prog.qh, prog.ms_class)
    for k in ("vlc", "magsgn", "pair"):
        errs[k] = max(errs[k], c[k]["max_abs_err"])
    del args
    before = _counts()
    got = [fr.tobytes() for fr in dec.decode_batch(batch)]
    batch_counts = _delta(before, _counts())
    singles = [Decoder(device=dev).decode(d).tobytes() for d in batch]
    host = [host_decoder.decode_frame(d, bitexact=True).tobytes()
            for d in batch]
    if got != singles or got != host or dec.v3_frames != 3 \
            or batch_counts != {**_expected_counts((1,) + (0,) * 9),
                                **prog.kernel_launches()} \
            or not inert:
        problems.append(f"batch of 3: equal to the singles "
                        f"{got == singles}, to the host oracle "
                        f"{got == host}, v3 frames {dec.v3_frames}, "
                        f"launches {batch_counts}, inert lanes {inert}")
    print(f"phase 10 decode_batch of 3 PPT-geometry frames: one V3Program "
          f"(F={prog.frames}, {c['lanes']['N']} lanes, {inert} inert), "
          f"launches {batch_counts}; == the 3 single decodes "
          f"{got == singles}, == the host oracle {got == host}")

    # the mutants: the card's decoder against the host oracle, one decoder
    # a base stream; any exception but J2KError (a CUDA fault among them)
    # ends the run here
    bases, muts = _mutants()
    outcomes = collections.Counter()
    decs = {name: Decoder(device=dev) for name in bases}
    before = _counts()
    for name, pos, bit in muts:
        data = bytearray(bases[name])
        data[pos] ^= bit
        data = bytes(data)
        card = _outcome(lambda: decs[name].decode(data))
        want = _outcome(lambda: host_decoder.decode_frame(data,
                                                          bitexact=True))
        if card != want:
            problems.append(f"mutant {name} byte {pos} bit {bit}: card "
                            f"{card[0]}, host {want[0]}")
        outcomes[(card == want, card[0])] += 1
    torch.cuda.synchronize()
    mutant_counts = _delta(before, _counts())
    mut_routes = {n: (d.v3_frames, d.v2_frames, d.host_frames)
                  for n, d in decs.items()}

    agreed = sum(n for (same, _k), n in outcomes.items() if same)
    j2k = sum(n for (same, k), n in outcomes.items() if same
              and k == "J2KError")
    secs = time.perf_counter() - t_phase
    print(f"phase 10 summary: {len(corpus)} streams by route "
          f"{dict(routes)}; {len(frames)} frames checked against the host "
          f"oracle, {sum(c.golden for c in corpus)} against their golden "
          f"framecrc, {sum(c.lossless for c in corpus)} against their "
          f"sources, and a batch of 3; {len(problems)} problems; mutants "
          f"{agreed}/{len(muts)} agreed, {j2k} of "
          f"them J2KError on both, card routes (v3, v2, host) "
          f"{mut_routes}, torch.cuda.synchronize() clean after them; "
          f"launches: corpus {counts}, batch {batch_counts}, mutants "
          f"{mutant_counts}; {secs:.1f} s")
    if problems:
        raise RuntimeError("phase 10: " + "; ".join(problems))
    return errs, {"c10_conformance": (counts, len(corpus))}


def _ok_line():
    return json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=["conformance", "programs"],
                    help="conformance: phases 1, 2 and 10 alone (the corpus "
                         "on the card, e.g. under compute-sanitizer); "
                         "programs: phases 1, 2 and 12 (with phase 7's two "
                         "c4 frames)")
    only = ap.parse_args(argv).only
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = _gpu_name_power()
    print(f"phase 1 card: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    kl = build.load()
    ptxas = [ln.strip() for ln in kl.log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"phase 2 build: {kl.build_seconds:.1f} s -> {build.LIB_PATH}; "
          + " | ".join(ptxas))
    t0 = time.perf_counter()
    native.load()
    print(f"phase 2 native tier loaded: {native.LIB_PATH} ("
          f"{time.perf_counter() - t0:.1f} s, from {native.NATIVE_DIR})")
    if only == "conformance":
        _phase10(dev)
        print(card)
        print(_ok_line())
        return 0
    if only == "programs":
        _phase12(dev, _c4_streams())
        print(card)
        print(_ok_line())
        return 0

    t0 = time.perf_counter()
    rng = np.random.default_rng(2024)
    sources = {"natural": _rgb(_natural(rng, H, W)),
               "smooth": _rgb(_smooth(H, W)),
               "worst": _rgb(rng.integers(0, 1 << DEPTH, (H, W),
                                          dtype=np.uint16))}
    streams = {k: encode_frame_htj2k(v, **ENC) for k, v in sources.items()}
    print(f"phase 3 encode (port encoder): {len(streams)} frames {W}x{H} "
          f"{DEPTH}-bit RGB 5/3+RCT, "
          f"{sum(map(len, streams.values())) / 3e6:.2f} MB/frame avg, "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- phase 4: kernels vs their plain versions on real lanes/planes
    t0 = time.perf_counter()
    hdr = parse_codestream(streams["natural"], bitexact=True)
    fg = FP.FlatGeometry(hdr)
    plan = ASM.build_plan(fg)
    fc = FP.build_v3_frame(fg, FP.parse_frame_flat(hdr, fg))
    stage = FP.Staging(dev)
    args_np, _ = finish_v3_numpy(fg, [fc], fg.geom.total, stage.alloc)
    prep_ms = (time.perf_counter() - t0) * 1e3
    args = stage.views(to_torch(stage.host, dev), 1)
    qw, qh = plan.bw // 2, plan.bh // 2
    mb = int(fc["maxbp"][fc["qws"] > 0].max())
    msc = next(c for c in (8, 12, 16, 20, 25) if mb <= c)
    c3 = _cleanup_check(args, _v3_segments([fc]), qw, qh, msc)
    ln = c3["lanes"]
    print(f"phase 4 HT cleanup on {ln['N']} lanes (qw=qh={qw}, ms_class="
          f"{msc}, W ms/mel/vlc = {'/'.join(map(str, ln['W']))}; segment "
          f"bytes MagSgn {ln['ms_bytes']}, MEL+VLC {ln['melvlc_bytes']}; "
          f"host prep {prep_ms:.0f} ms)")
    _print_cleanup("phase 4", c3)
    print(f"phase 4   pair {c3['pair']['ms']:.4f} ms vs "
          f"{ONE_THREAD_CLEANUP_MS} ms for the earlier "
          "one-thread-per-codeblock kernel")

    # in the layout the decoder picks: rgb48le, R, G, B interleaved << 6
    prog = V3Program(plan, fg.geom.key(), qw=qw, qh=qh, ms_class=msc,
                     n_pad=fg.ncblks, frames=1,
                     layout=DEC.frame_layout([hdr], fg.geom),
                     no_istep=bool(np.all(args_np["istep"] == 32768)))
    outs, _ok = prog.decode_planes(**args)
    rct = _rct_check(prog, outs)
    rct_err, rct_ms = rct["max_abs_err"], rct["ms"]
    rct_plain_ms, rct_bound = rct["plain_ms"], rct["bound_ms"]
    program_ms = _cuda_ms(lambda: prog(**args), 5)
    print(f"phase 4 rct kernel == rct_writeframe_ref in the "
          f"{prog.frame_layout.fmt.name} layout on 3 x {H}x{W} "
          f"planes (min {rct['chroma'][0]}, max {rct['chroma'][1]} chroma): "
          f"kernel {rct_ms:.4f} ms, plain {rct_plain_ms:.3f} ms, bound "
          f"{rct_bound:.4f} ms (bytes), {100 * rct_bound / rct_ms:.1f}% of "
          f"bound; whole device program {program_ms:.2f} ms/frame")
    del outs, args

    # ---- phase 5: the main path through the public entry point
    dec = Decoder(device="cuda")
    order = list(streams)
    _reset_counts()
    frames = list(dec.decode_stream([streams[k] for k in order]))
    launches = _counts()
    for k, fr in zip(order, frames):
        want = sources[k].astype(np.uint16) << (16 - DEPTH)
        if fr.fmt.name != "rgb48le" or fr.planes[0].shape != (H, 3 * W) \
                or not np.array_equal(fr.planes[0].reshape(H, W, 3), want):
            raise RuntimeError(f"frame {k!r} ({fr.fmt.name}) differs from "
                               "its source")
    if dec.v3_frames != len(order) or dec.host_frames:
        raise RuntimeError(f"v3 frames {dec.v3_frames}, host frames "
                           f"{dec.host_frames}")
    want = {k: 0 if k in ("ict_writeframe", *_REFINE, "wire_pack")
            else len(order) for k in _KERNELS}
    want.update(_lift_want(dec, streams["natural"], 1, len(order)))
    if launches != want:
        raise RuntimeError(f"launches {launches}, expected {want}: the "
                           "cleanup pair, RCT and coef_mosaic once a "
                           "frame, dwt_lift once a level of a frame")
    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _fr in dec.decode_stream([streams[k] for k in order]):
            pass
        times.append((time.perf_counter() - t0) * 1e3 / len(order))
    print(f"phase 5 decode_stream: {len(order)} frames == source "
          f"(rgb48le, << {16 - DEPTH}), all via the v3 device program; "
          f"launches {launches}; median {statistics.median(times):.1f} "
          f"ms/frame over {REPS} reps of {len(order)} frames "
          f"({', '.join(f'{t:.1f}' for t in times)})")

    # where one frame's time goes: the calls Decoder.decode makes, timed
    # one by one with a device sync after each device step
    print("phase 5 one natural frame, ms: "
          + _laps(dec, [streams["natural"]], True, dev))

    # ---- phase 6: the c2 irreversible path
    ict_entry, c2, c2_paths, c2_streams = _phase6(dev)

    # ---- phase 7: BASELINE config 4 (a crop), the v2 bucketed path
    refine_entries, c4, c4_paths, c4_data = _phase7(dev)

    # ---- phase 8: BASELINE config 5, an MXF of four 4K frames
    wire_entry, c5_paths, c5_data = _phase8(dev, sources["natural"],
                                            streams["natural"])

    # ---- phase 9: phase 8's batch sharded over the card listed D times
    c9, c9_paths = _phase9(dev, c5_data, c4_data,
                           wire_entry["decode_batch_ms_per_frame"])

    # ---- phase 10: the conformance corpus on the card
    c10, c10_paths = _phase10(dev)
    # ---- phase 11: the coefficient stages' kernels on c3 and c2
    c11 = _phase11(dev, streams["natural"], c2_streams)
    # ---- phase 12: the v2 program and the flat fallback on config 4
    c12, c12_paths, c12_regs = _phase12(dev, c4_data)

    c10_errs = {**{k: c10[k] for k in _PROGRAM}, "ht_vlc_pass": c10["vlc"],
                "ht_magsgn_pass": max(c10["magsgn"], c10["pair"]),
                "rct_writeframe": c10["rct"], "ict_writeframe": c10["ict"],
                "ht_sigprop_pass": c10["sigprop"],
                "ht_magref_pass": max(c10["magref"], c10["refine_pair"]),
                "wire_pack": c10["wire_pack"]}

    cleanup_src = "ffmpeg_ht_tpu/ops/ht_scan_pallas.py:192"
    kernels = [
        dict(name="ht_vlc_pass", route="cuda",
             source="ffmpeg_ht_tpu_torch/csrc/ht_vlc_pass.cu",
             replaces=cleanup_src, **c3["vlc"],
             c2_decode_batch_shapes=c2["vlc"],
             c4_decode_batch_buckets=c4["vlc"],
             c5_shard_lanes=c9["vlc"]),
        dict(name="ht_magsgn_pass", route="cuda",
             source="ffmpeg_ht_tpu_torch/csrc/ht_magsgn_pass.cu",
             replaces=cleanup_src, **c3["magsgn"],
             c2_decode_batch_shapes=c2["magsgn"],
             c4_decode_batch_buckets=c4["magsgn"],
             c5_shard_lanes=c9["magsgn"]),
        dict(name="rct_writeframe", route="cuda",
             source="ffmpeg_ht_tpu_torch/csrc/rct_writeframe.cu",
             replaces="ffmpeg_ht_tpu/ops/mct_pallas.py:36",
             max_abs_err=rct_err, ms=rct_ms, plain_ms=rct_plain_ms,
             bound_ms=rct_bound, c5_shard_lanes=c9["rct"]),
        ict_entry,
        *refine_entries,
        wire_entry,
        *[dict(name=k, route="cuda",
               source=f"ffmpeg_ht_tpu_torch/csrc/{k}.cu", replaces=where,
               **c11["c3"][k],
               c2_decode_batch_shapes=c11["c2_float"][k],
               c2_decode_stream_int_shapes=c11["c2_int"][k],
               v3_program={c: c11[c]["program"] for c in c11})
          for k, where in (
              ("coef_mosaic", "ffmpeg_ht_tpu/models/assembly.py:326"),
              ("dwt_lift", "ffmpeg_ht_tpu/ops/dwt_jax.py:330"))],
        # phase 12: the v2 program's and the flat fallback's kernels, each
        # timed on its main path's program (the c4 decode_batch for
        # bucket_scatter and plane_writeframe, the crop's V3Program for
        # dwt_small); no single PyTorch call computes their functions (an
        # index_put_ of bucket_scatter's values at a precomputed index is
        # its yardstick, without the dequant)
        *[dict(name=k, route="cuda",
               source=f"ffmpeg_ht_tpu_torch/csrc/{k}.cu", replaces=where,
               **{f: v for f, v in c12[main][k].items()
                  if f != "index_put_ms"},
               index_put_yardstick_ms=c12[main][k].get("index_put_ms"),
               ptxas={r: v for r, v in c12_regs.items() if r.startswith(kn)},
               phase12={c: c12[c][k] for c in c12 if k in c12[c]},
               program={c: c12[c]["program"] for c in c12})
          for k, where, main, kn in (
              ("bucket_scatter", "ffmpeg_ht_tpu/models/decoder.py:481",
               "c4_batch", "scatter_"),
              ("dwt_small", "ffmpeg_ht_tpu/ops/dwt_jax.py:362", "crop_v3",
               "small_levels"),
              ("plane_writeframe", "ffmpeg_ht_tpu/models/assembly.py:389",
               "c4_batch", "writeframe_kernel"))],
    ]
    for k in kernels:
        if k["name"] in ("coef_mosaic", "dwt_lift"):
            k["phase12"] = {c: c12[c][k["name"]] for c in c12
                            if k["name"] in c12[c]}
    # every path's run is read between a reset and the next; `launches`
    # is the count on the kernel's main path, the path whose shapes its
    # ms and bound_ms were measured at: c3 decode_stream (phase 5) for the
    # kernels of the 5/3 slice and the coefficient stages' (phase 11
    # measures them on that path's program), c2 decode_batch (phase 6) for
    # ICT, c4 decode_batch (phase 7) for the two refinement kernels,
    # bucket_scatter and plane_writeframe (phase 12 measures them on that
    # path's program), c5 decode_batch (phase 8) for the wire pack, the
    # crop's single-layer decode (phase 12) for dwt_small
    paths = {"c3_decode_stream": (launches, len(order)), **c2_paths,
             **c4_paths, **c5_paths, **c9_paths, **c10_paths, **c12_paths}
    main_paths = {"ict_writeframe": "c2_decode_batch",
                  "ht_sigprop_pass": "c4_decode_batch",
                  "ht_magref_pass": "c4_decode_batch",
                  "wire_pack": "c5_decode_batch",
                  "bucket_scatter": "c4_decode_batch",
                  "plane_writeframe": "c4_decode_batch",
                  "dwt_small": "c12_crop_v3_decode"}
    for k in kernels:
        main_path = main_paths.get(k["name"], "c3_decode_stream")
        n = {p: c[k["name"]] for p, (c, _f) in paths.items()}
        per_frame = {p: n[p] / f for p, (_c, f) in paths.items()}
        k["c10_conformance"] = dict(max_abs_err=c10_errs[k["name"]])
        k["max_abs_err"] = max([k["max_abs_err"]] + [
            k.get(s, {}).get("max_abs_err", 0)
            for s in ("c2_decode_batch_shapes", "c2_decode_stream_int_shapes",
                      "c4_decode_batch_buckets", "c5_shard_lanes",
                      "c10_conformance")]
            + [v["max_abs_err"] for v in k.get("phase12", {}).values()])
        # no single PyTorch call computes an HT cleanup pass, SigProp /
        # MagRef, RCT or ICT with DC shift, clip and the narrow pack, the
        # 32-sample-group bit pack, the dequant + prefill + band mosaic or
        # scatter, a DC shift + clip + narrow pack of many planes, nor a
        # lifting level of the JPEG 2000 inverse DWT
        k.update(main_path=main_path, launches=n[main_path],
                 launches_per_frame=per_frame[main_path],
                 launches_by_path=n, launches_per_frame_by_path=per_frame,
                 frames_by_path={p: f for p, (_c, f) in paths.items()},
                 bound_by="bytes", library_ms=None)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(_ok_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
