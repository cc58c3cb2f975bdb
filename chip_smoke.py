#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``ffmpeg_ht_tpu_torch`` end to end at the headline size: three
seeded DCI-4K (4096x2160) 10-bit 4:4:4 lossless frames (reversible 5/3 +
RCT, 64x64 codeblocks, one 4096x4096 tile), decoded by
``Decoder(device="cuda").decode_stream``. Phases, one line each; any
failure raises and the script exits non-zero:

  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ffmpeg_ht_tpu_torch/csrc and the port's
     native host tier from ffmpeg_ht_tpu_torch/native;
  3. encode the three frames with the port's encoder (natural
     value-noise, smooth, uniform random);
  4. each kernel against its plain PyTorch version on the card, on the
     first frame's real lanes and planes: the HT cleanup's VLC pass
     (records exact), its MagSgn pass (on the same records) and the pair
     against ``cleanup_ref``, then RCT; each with its time by CUDA
     events, its bound from the bytes these inputs need, and the share
     of the bound;
  5. the main path: launch counts reset, three frames decoded, counts
     read; every frame must equal its source in the negotiated pixel
     format (rgb48le, samples << 6), every kernel must have launched once
     per frame and all frames must have gone through the v3 device
     program; then the median ms per frame over a few repetitions.

The last lines are the card's name and power limit, a JSON object with
the per-kernel numbers and ``{"ok": true, "device": {...}}``. Needs no
network, no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
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

from ffmpeg_ht_tpu_torch.codestream.parser import parse_codestream
from ffmpeg_ht_tpu_torch.models import assembly as ASM
from ffmpeg_ht_tpu_torch.models import fastpath as FP
from ffmpeg_ht_tpu_torch.models.assembly import V3Program
from ffmpeg_ht_tpu_torch.models.decoder import Decoder
from ffmpeg_ht_tpu_torch.models.encoder import encode_frame_htj2k
from ffmpeg_ht_tpu_torch.models.fastpath import finish_v3_numpy, to_torch
from ffmpeg_ht_tpu_torch.ops import ht_scan, mct_cuda
from ffmpeg_ht_tpu_torch.utils import build, native

W, H, DEPTH = 4096, 2160, 10
ENC = dict(depth=DEPTH, tile_width=4096, tile_height=4096,
           log2_cblk_width=6, log2_cblk_height=6, mct=True)
REPS = 3
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, published, at the 700 W limit
# the earlier cleanup kernel, one thread per codeblock, on an H100 80GB
# HBM3 at 700 W (PERF.md, section 6): printed beside the split design
ONE_THREAD_CLEANUP_MS = 2.46


def _natural(rng, h, w):
    """Mixed-frequency value noise (octaves at 8/32/128/512 px), 10-bit."""
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
    return (acc * 1023).astype(np.uint16)


def _smooth(h, w):
    base = np.sin(np.linspace(0, 7, h)[:, None]) \
        * np.cos(np.linspace(0, 11, w)[None, :])
    return (((base + 1) / 2) * 1023).astype(np.uint16)


def _rgb(plane):
    return np.stack([plane, np.roll(plane, 5, 1), np.roll(plane, 9, 0)], 2)


def _gpu_name_power() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "-i", os.environ["CUDA_VISIBLE_DEVICES"],
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps: int) -> float:
    """Mean device ms per call of fn() over `reps` calls (CUDA events,
    after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def main() -> int:
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
    args_np, _ = finish_v3_numpy(fg, [fc], fg.geom.total)
    prep_ms = (time.perf_counter() - t0) * 1e3
    args = {k: to_torch(v, dev) for k, v in args_np.items()}
    qw, qh = plan.bw // 2, plan.bh // 2
    dev_lanes = fc["qws"] > 0
    mb = int(fc["maxbp"][dev_lanes].max())
    msc = next(c for c in (8, 12, 16, 20, 25) if mb <= c)
    (msw, melw, vlcw, pLSB, maxbp, ms_lim, mel_lim, qws, qhs) = (
        args[k] for k in ("msw", "melw", "vlcw", "pLSB", "maxbp", "ms_lim",
                          "mel_lim", "qws", "qhs"))
    N = msw.shape[0]
    vlc_in = (melw, vlcw, mel_lim, qws, qhs, qw, qh)
    u32 = lambda t: t.to(torch.int64) & 0xFFFFFFFF

    rec_k = ht_scan.ht_vlc_pass(*vlc_in)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rec_r = ht_scan.vlc_pass_ref(*vlc_in)
    torch.cuda.synchronize()
    vlc_plain_ms = (time.perf_counter() - t1) * 1e3
    vlc_err = int((rec_k.to(torch.int64) - rec_r.to(torch.int64))
                  .abs().max())
    if vlc_err:
        raise RuntimeError(f"VLC pass differs from vlc_pass_ref (max abs "
                           f"err {vlc_err})")

    ms_in = (msw, pLSB, maxbp, ms_lim, qws, qhs, qw, qh, msc)
    mu_k, sig_k, ok_k = ht_scan.ht_magsgn_pass(rec_r, *ms_in)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mu_r, sig_r, ok_r = ht_scan.magsgn_pass_ref(rec_r, *ms_in)
    torch.cuda.synchronize()
    magsgn_plain_ms = (time.perf_counter() - t1) * 1e3
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
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mu_r, sig_r, ok_r = ht_scan.cleanup_ref(*lane_args, qw, qh, msc)
    torch.cuda.synchronize()
    cleanup_plain_ms = (time.perf_counter() - t1) * 1e3
    if not torch.equal(ok_k, ok_r) or not bool(ok_r.all()):
        raise RuntimeError("cleanup pair: ok flags differ from cleanup_ref"
                           " or a lane failed")
    cleanup_err = max(int((u32(mu_k) - u32(mu_r)).abs().max()),
                      int((sig_k - sig_r).abs().max()))
    if cleanup_err:
        raise RuntimeError(f"cleanup pair differs from cleanup_ref "
                           f"(max abs err {cleanup_err})")

    vlc_ms = _cuda_ms(lambda: ht_scan.ht_vlc_pass(*vlc_in), 10)
    magsgn_ms = _cuda_ms(lambda: ht_scan.ht_magsgn_pass(rec_r, *ms_in), 10)
    cleanup_ms = _cuda_ms(lambda: ht_scan.decode_cleanup_scan_dims(
        *lane_args, qw, qh, msc), 10)
    # bytes these inputs need: the segment bytes of the decoded lanes
    # (MagSgn: [0, pcup); MEL and VLC: [pcup, lcup)), the per-lane
    # vectors, the records, and mu + sig + ok
    lc = fc["lcups"][dev_lanes].astype(np.int64)
    pc = fc["pcups"][dev_lanes].astype(np.int64)
    ms_bytes, melvlc_bytes = int(pc.sum()), int((lc - pc).sum())
    rec_bytes = 4 * N * qh * qw
    out_bytes = 4 * mu_k.numel() + 4 * sig_k.numel() + N
    bound = lambda nbytes: nbytes / HBM_BYTES_PER_S * 1e3
    vlc_bound = bound(melvlc_bytes + 12 * N + 8192 + rec_bytes)
    magsgn_bound = bound(rec_bytes + ms_bytes + 20 * N + out_bytes)
    cleanup_bound = bound(ms_bytes + melvlc_bytes + 32 * N + 8192
                          + out_bytes)
    print(f"phase 4 HT cleanup on {N} lanes (qw=qh={qw}, ms_class={msc}, "
          f"W ms/mel/vlc = {msw.shape[1]}/{melw.shape[1]}/{vlcw.shape[1]}"
          f"; segment bytes MagSgn {ms_bytes}, MEL+VLC {melvlc_bytes}; "
          f"host prep {prep_ms:.0f} ms)")
    for name, ms, plain, bnd in (
            ("VLC pass == vlc_pass_ref (records)", vlc_ms, vlc_plain_ms,
             vlc_bound),
            ("MagSgn pass == magsgn_pass_ref (same records)", magsgn_ms,
             magsgn_plain_ms, magsgn_bound),
            ("pair == cleanup_ref", cleanup_ms, cleanup_plain_ms,
             cleanup_bound)):
        print(f"phase 4   {name}: kernel {ms:.4f} ms, plain {plain:.1f} ms"
              f", bound {bnd:.4f} ms (bytes), {100 * bnd / ms:.1f}% of "
              "bound")
    print(f"phase 4   pair {cleanup_ms:.4f} ms vs {ONE_THREAD_CLEANUP_MS} ms "
          "for the earlier one-thread-per-codeblock kernel")

    prog = V3Program(plan, fg.geom.key(), qw=qw, qh=qh, ms_class=msc,
                     n_pad=fg.ncblks, frames=1,
                     no_istep=bool(np.all(args_np["istep"] == 32768)))
    outs, _ok = prog.decode_planes(**args)
    y0, y1, y2 = (c.contiguous() for c in outs[:3])
    npx = y0.numel()
    ref = mct_cuda.rct_writeframe_ref(y0, y1, y2, DEPTH)
    got = mct_cuda.rct_writeframe(y0, y1, y2, DEPTH)
    rct_err = max(int((a - b).abs().max()) for a, b in zip(got, ref))
    packed_k = torch.empty(3 * npx, dtype=torch.int16, device=dev)
    packed_r = torch.empty_like(packed_k)
    mct_cuda.rct_writeframe(y0, y1, y2, DEPTH, out=packed_k)

    def rct_plain():
        for i, c in enumerate(mct_cuda.rct_writeframe_ref(y0, y1, y2, DEPTH)):
            packed_r[i * npx:(i + 1) * npx] = \
                mct_cuda.narrow(c, torch.int16).reshape(-1)

    rct_plain()
    rct_err = max(rct_err, int((packed_k.to(torch.int32)
                                - packed_r.to(torch.int32)).abs().max()))
    if rct_err:
        raise RuntimeError(f"RCT kernel differs from its plain version "
                           f"(max abs err {rct_err})")
    rct_ms = _cuda_ms(lambda: mct_cuda.rct_writeframe(
        y0, y1, y2, DEPTH, out=packed_k), 20)
    rct_plain_ms = _cuda_ms(rct_plain, 20)
    rct_bound = bound(3 * npx * 4 + packed_k.numel() * 2)
    program_ms = _cuda_ms(lambda: prog(**args), 5)
    print(f"phase 4 rct kernel == rct_writeframe_ref + pack on 3 x {H}x{W} "
          f"planes (min {int(y1.min())}, max {int(y1.max())} chroma): "
          f"kernel {rct_ms:.4f} ms, plain {rct_plain_ms:.3f} ms, bound "
          f"{rct_bound:.4f} ms (bytes), {100 * rct_bound / rct_ms:.1f}% of "
          f"bound; whole device program {program_ms:.2f} ms/frame")
    del outs, y0, y1, y2, ref, got, mu_r, sig_r, mu_k, sig_k, rec_k, rec_r

    # ---- phase 5: the main path through the public entry point
    dec = Decoder(device="cuda")
    order = list(streams)
    ht_scan.ht_vlc_pass.launches = 0
    ht_scan.ht_magsgn_pass.launches = 0
    mct_cuda.rct_writeframe.launches = 0
    frames = list(dec.decode_stream([streams[k] for k in order]))
    launches = {"ht_vlc_pass": ht_scan.ht_vlc_pass.launches,
                "ht_magsgn_pass": ht_scan.ht_magsgn_pass.launches,
                "rct_writeframe": mct_cuda.rct_writeframe.launches}
    for k, fr in zip(order, frames):
        want = sources[k].astype(np.uint16) << (16 - DEPTH)
        if fr.fmt.name != "rgb48le" or fr.planes[0].shape != (H, 3 * W) \
                or not np.array_equal(fr.planes[0].reshape(H, W, 3), want):
            raise RuntimeError(f"frame {k!r} ({fr.fmt.name}) differs from "
                               "its source")
    if dec.v3_frames != len(order) or dec.host_frames:
        raise RuntimeError(f"v3 frames {dec.v3_frames}, host frames "
                           f"{dec.host_frames}")
    if any(n != len(order) for n in launches.values()):
        raise RuntimeError(f"launches {launches}, expected one per frame "
                           f"({len(order)})")
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
    laps = {}
    hdr = parse_codestream(streams["natural"], bitexact=True)
    fg = dec._fast_geom(hdr)
    (prog,) = fg.v3_progs.values()
    val = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for name, step in (
            ("parse", lambda _: parse_codestream(streams["natural"],
                                                 bitexact=True)),
            ("t2_native", lambda _: FP.parse_frame_flat(hdr, fg)),
            ("build_v3_frame", lambda cols: FP.build_v3_frame(fg, cols)),
            ("stream_prep", lambda fc: finish_v3_numpy(fg, [fc],
                                                       fg.geom.total)[0]),
            ("upload", lambda a: {k: to_torch(v, dev) for k, v in a.items()}),
            ("device_program", lambda a: prog(**a)),
            ("fetch", lambda p: p.cpu()),
            ("write_frame", lambda p: dec._finish(hdr, fg.tiles, fg.geom,
                                                  p))):
        val = step(val)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        laps[name] = (t1 - t0) * 1e3
        t0 = t1
    total = sum(laps.values())
    print("phase 5 one natural frame, ms: " + " | ".join(
        f"{k} {v:.1f}" for k, v in laps.items())
        + f" | total {total:.1f}; device program "
        f"{100 * laps['device_program'] / total:.1f}% of it")

    cleanup_src = "ffmpeg_ht_tpu/ops/ht_scan_pallas.py:192"
    kernels = [
        dict(name="ht_vlc_pass", route="cuda",
             source="ffmpeg_ht_tpu_torch/csrc/ht_vlc_pass.cu",
             replaces=cleanup_src, max_abs_err=vlc_err, ms=vlc_ms,
             plain_ms=vlc_plain_ms, bound_ms=vlc_bound),
        dict(name="ht_magsgn_pass", route="cuda",
             source="ffmpeg_ht_tpu_torch/csrc/ht_magsgn_pass.cu",
             replaces=cleanup_src, max_abs_err=magsgn_err, ms=magsgn_ms,
             plain_ms=magsgn_plain_ms, bound_ms=magsgn_bound),
        dict(name="rct_writeframe", route="cuda",
             source="ffmpeg_ht_tpu_torch/csrc/rct_writeframe.cu",
             replaces="ffmpeg_ht_tpu/ops/mct_pallas.py:36",
             max_abs_err=rct_err, ms=rct_ms, plain_ms=rct_plain_ms,
             bound_ms=rct_bound),
    ]
    for k in kernels:
        # no single PyTorch call computes an HT cleanup pass, nor RCT with
        # DC shift, clip and the narrow pack
        k.update(launches=launches[k["name"]],
                 launches_per_frame=launches[k["name"]] / len(order),
                 bound_by="bytes", library_ms=None)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
