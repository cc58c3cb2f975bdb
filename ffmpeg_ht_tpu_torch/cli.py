"""jxt-torch — the command-line tool of the PyTorch/CUDA port (the
reference's `ffmpeg`/`ffprobe` tier; counterpart of ffmpeg_ht_tpu/cli.py,
same subcommands and flags).

    jxt-torch decode INPUT [-o OUT] [-f rawvideo|framecrc|framemd5|md5]
                     [--host] [--no-bitexact] [--lowres N] [--benchmark]
                     [--device-resident] [--device cuda|cpu]
    jxt-torch encode RAW -s WxH --pix-fmt FMT [-o OUT] [--codec ht|j2k]
                     [--pred {0,1}] [--prog lrcp|rlcp|rpcl|pcrl|cprl]
                     [--tile-width N] [--tile-height N] [--sop] [--eph]
                     [--layer-rates R1,R2,...] [-q N] [--jp2]
    jxt-torch probe INPUT

(`jxt-torch ...` once installed, or `python -m ffmpeg_ht_tpu_torch.cli
...`.) Pipeline parity: fftools/ffmpeg.c transcode + ffmpeg_dec.c
packet_decode (SURVEY.md §3.1); `--benchmark` mirrors `ffmpeg -benchmark`
(fftools/ffmpeg_opt.c:1613-1615: wall/user time + max RSS). `--device`
names the torch device of every Decoder (default cuda); asking for cuda
without a usable card is an error, never a quiet run on the CPU.
`--host` decodes on the host oracle. With JXT_PROFILE=DIR, the decode
writes a torch.profiler trace (Chrome JSON) to DIR/jxt_trace.json.
"""

from __future__ import annotations

import argparse
import os
import resource
import sys
import time

import numpy as np

from ffmpeg_ht_tpu_torch.containers import demux, mux
from ffmpeg_ht_tpu_torch.utils.log import logger


def _cmd_decode(args) -> int:
    from ffmpeg_ht_tpu_torch.models import host_decoder
    from ffmpeg_ht_tpu_torch.models.decoder import Decoder

    from ffmpeg_ht_tpu_torch.utils.device import resolve_device

    device = None
    if not args.host:
        try:
            device = resolve_device(args.device)
        except (RuntimeError, ValueError) as e:
            logger.error(str(e))
            return 1

    profile_dir = os.environ.get("JXT_PROFILE")
    prof = None
    if profile_dir:
        # device-level tracing (the START_TIMER/av_log TRACE analog):
        # a Chrome trace, viewed with chrome://tracing or Perfetto
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device is not None and device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()

    t0 = time.perf_counter()
    u0 = resource.getrusage(resource.RUSAGE_SELF)

    frames = []
    streams = list(demux.demux_file(args.input))
    if not streams:
        logger.error("no frames found in input")
        return 1
    if getattr(args, "device_resident", False):
        # chip-rate measurement: decode the input's frames back-to-back
        # device-resident (no host parse, no output fetch in the timed
        # region), on any user stream (Decoder.bench_resident docstring
        # has the full contract)
        if not args.benchmark:
            logger.error("--device-resident requires --benchmark")
            return 1
        dec = Decoder(device=device, bitexact=args.bitexact)
        try:
            res = dec.bench_resident(streams)
        except ValueError as e:
            logger.error(f"device-resident bench unavailable: {e}")
            return 1
        print(f"bench: device-resident fps={res['fps']:.3f} "
              f"ms_per_frame={res['ms_per_frame']:.2f} "
              f"frames_merged={res['frames_merged']}", file=sys.stderr)
        return 0
    if args.host:
        for s in streams:
            frames.append(host_decoder.decode_frame(
                s, bitexact=args.bitexact,
                reduction_factor=args.lowres,
                max_layers=args.max_layers))
    else:
        dec = Decoder(device=device, bitexact=args.bitexact,
                      reduction_factor=args.lowres,
                      max_layers=args.max_layers)
        pending = [dec.decode_async(s) for s in streams]
        frames = [p() for p in pending]

    if getattr(args, "pix_fmt", None):
        from ffmpeg_ht_tpu_torch.models.swscale import convert
        try:
            frames = [convert(f, args.pix_fmt) for f in frames]
        except ValueError as e:
            logger.error(str(e))
            return 1

    if args.format == "rawvideo":
        payload = mux.rawvideo(frames)
        _write(args.output, payload, binary=True)
    elif args.format == "framecrc":
        _write(args.output, mux.framecrc(frames))
    elif args.format == "framemd5":
        _write(args.output, mux.framemd5(frames))
    elif args.format == "md5":
        _write(args.output, mux.md5_total(frames))
    elif args.format == "null":
        pass
    else:
        logger.error(f"unknown output format {args.format}")
        return 1

    if prof is not None:
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
        prof.stop()
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "jxt_trace.json"))
        logger.info(f"profile written to {profile_dir}")

    if args.benchmark:
        u1 = resource.getrusage(resource.RUSAGE_SELF)
        wall = time.perf_counter() - t0
        print(f"bench: utime={u1.ru_utime - u0.ru_utime:.3f}s "
              f"stime={u1.ru_stime - u0.ru_stime:.3f}s "
              f"rtime={wall:.3f}s", file=sys.stderr)
        print(f"bench: maxrss={u1.ru_maxrss}KiB "
              f"frames={len(frames)} fps={len(frames) / wall:.2f}",
              file=sys.stderr)
    return 0


def _cmd_encode(args) -> int:
    from ffmpeg_ht_tpu_torch.models.encoder import (encode_frame_htj2k,
                                              encode_frame_t800)

    w, h = (int(x) for x in args.size.split("x"))
    raw = open(args.input, "rb").read() if args.input != "-" \
        else sys.stdin.buffer.read()

    pix = args.pix_fmt
    if pix == "gray":
        img = np.frombuffer(raw, np.uint8)
        frame_px = w * h
        shape = (h, w)
        chroma = (0, 0)
        planar = None
    elif pix == "gray16le":
        img = np.frombuffer(raw, "<u2")
        frame_px = w * h
        shape = (h, w)
        chroma = (0, 0)
        planar = None
    elif pix == "rgb24":
        img = np.frombuffer(raw, np.uint8)
        frame_px = w * h * 3
        shape = (h, w, 3)
        chroma = (0, 0)
        planar = None
    elif pix in ("yuv420p", "yuv422p", "yuv444p"):
        chroma = {"yuv420p": (1, 1), "yuv422p": (1, 0),
                  "yuv444p": (0, 0)}[pix]
        cw, ch_ = w >> chroma[0], h >> chroma[1]
        frame_px = w * h + 2 * cw * ch_
        img = np.frombuffer(raw, np.uint8)
        planar = (w, h, cw, ch_)
        shape = None
    else:
        logger.error(f"unsupported pix_fmt {pix}")
        return 1

    nframes = len(img) // frame_px
    opts = dict(pred=args.pred, prog=args.prog,
                tile_width=args.tile_width, tile_height=args.tile_height,
                sop=args.sop, eph=args.eph, tp_interval=args.tp_interval)
    if args.layer_rates:
        opts["layer_rates"] = [int(x) for x in args.layer_rates.split(",")]
    if args.quality:
        opts["quality"] = args.quality

    outs = []
    for i in range(nframes):
        chunk = img[i * frame_px:(i + 1) * frame_px]
        if planar:
            w_, h_, cw, ch_ = planar
            y = chunk[:w_ * h_].reshape(h_, w_)
            u = chunk[w_ * h_:w_ * h_ + cw * ch_].reshape(ch_, cw)
            v = chunk[w_ * h_ + cw * ch_:].reshape(ch_, cw)
            frame_in = [y, u, v]
        else:
            frame_in = chunk.reshape(shape)
        if args.codec == "ht":
            outs.append(encode_frame_htj2k(frame_in, chroma_shift=chroma,
                                           **opts))
        else:
            opts2 = dict(opts)
            if args.jp2:
                opts2["jp2"] = True
            outs.append(encode_frame_t800(frame_in, chroma_shift=chroma,
                                          **opts2))

    if args.output and args.output.endswith((".mj2", ".mov")):
        # container extension wins over the single-frame shortcut so a
        # 1-frame encode to out.mj2 is properly MJ2-wrapped
        from ffmpeg_ht_tpu_torch.containers.mov import mux_mj2
        _write(args.output, mux_mj2(outs, w, h), binary=True)
    elif args.output and args.output.endswith(".mxf"):
        from ffmpeg_ht_tpu_torch.containers.mxf import mux_mxf
        ncomp = 1 if pix.startswith("gray") else 3
        depth = 16 if pix.endswith("16le") else 8
        _write(args.output, mux_mxf(outs, w, h, ncomp=ncomp, depth=depth,
                                    chroma_shifts=tuple(chroma)),
               binary=True)
    elif nframes == 1 and "%" not in (args.output or ""):
        _write(args.output, outs[0], binary=True)
    elif args.output and "%" in args.output:
        for i, o in enumerate(outs):
            with open(args.output % i, "wb") as f:
                f.write(o)
    else:
        _write(args.output, b"".join(outs), binary=True)
    return 0


def _cmd_probe(args) -> int:
    from ffmpeg_ht_tpu_torch.codestream.parser import parse_codestream
    from ffmpeg_ht_tpu_torch.models import pixfmt as pf

    fmt = demux.probe_file(args.input)
    streams = list(demux.demux_file(args.input))
    print(f"format: {fmt}")
    print(f"frames: {len(streams)}")
    if streams:
        hdr = parse_codestream(streams[0])
        siz = hdr.siz
        pxf = pf.negotiate(siz, hdr.colour_space, siz.rsiz)
        cod = hdr.codsty[0]
        kind = "htj2k" if (cod.cblk_style & 0x40) else "jpeg2000"
        from ffmpeg_ht_tpu_torch.codestream.profiles import profile_name
        print(f"codec: {kind}")
        print(f"profile: {profile_name(siz.rsiz)}")
        print(f"dimensions: {siz.width - siz.x0}x{siz.height - siz.y0}")
        print(f"components: {siz.ncomponents}  depth: {siz.precision}")
        print(f"pix_fmt: {pxf.name}")
        print(f"tiles: {siz.num_x_tiles}x{siz.num_y_tiles} "
              f"({siz.tile_width}x{siz.tile_height})")
        print(f"levels: {cod.nreslevels - 1}  "
              f"cblk: {1 << cod.log2_cblk_width}x"
              f"{1 << cod.log2_cblk_height}")
        print(f"transform: {'5/3' if cod.transform == 1 else '9/7'}")
        print(f"progression: "
              f"{['LRCP','RLCP','RPCL','PCRL','CPRL'][cod.prog_order]}")
        print(f"layers: {cod.nlayers}")
        # index tables: the random-access budget (TLM seeks tile-parts,
        # decode_tile skips other tiles' bytes; PLT seeks packets,
        # discarded layers skip bytewise)
        if hdr.tlm_records:
            print(f"tlm: {len(hdr.tlm_records)} tile-parts, "
                  f"{sum(p for _, p in hdr.tlm_records)} seekable bytes"
                  f" ({hdr.tlm_skipped} skipped this parse)")
        plt_pkts = sum(len(th.plt_lengths) for th in hdr.tiles)
        if plt_pkts:
            print(f"plt: {plt_pkts} packets, "
                  f"{sum(sum(th.plt_lengths) for th in hdr.tiles)} "
                  f"seekable bytes")
        extras = [n for n, f in (("ppm", hdr.has_ppm),
                                 ("ppt", any(t.has_ppt for t in hdr.tiles)),
                                 ("poc", any(t.poc.entries
                                             for t in hdr.tiles)))
                  if f]
        if extras:
            print(f"features: {', '.join(extras)}")
    return 0


def _write(path, payload, binary=False):
    if path in (None, "-"):
        if binary:
            sys.stdout.buffer.write(payload)
        else:
            sys.stdout.write(payload)
    else:
        mode = "wb" if binary else "w"
        with open(path, mode) as f:
            f.write(payload)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="jxt-torch",
                                description="JPEG 2000 / HTJ2K codec tool "
                                            "(PyTorch / CUDA)")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("decode", help="decode to raw video / checksums")
    d.add_argument("input")
    d.add_argument("-o", "--output", default="-")
    d.add_argument("-f", "--format", default="rawvideo",
                   choices=["rawvideo", "framecrc", "framemd5", "md5",
                            "null"])
    d.add_argument("--host", action="store_true",
                   help="force the host (CPU oracle) decode path")
    d.add_argument("--no-bitexact", dest="bitexact", action="store_false",
                   help="use the float 9/7 path (default: bitexact int)")
    d.add_argument("--lowres", type=int, default=0,
                   help="resolution reduction factor (decoder lowres)")
    d.add_argument("--max-layers", type=int, default=0,
                   help="decode only the first N quality layers "
                        "(progressive-quality cap; 0 = all)")
    d.add_argument("--pix-fmt", dest="pix_fmt", default=None,
                   help="convert output to this pixel format "
                        "(models/swscale.py, the libswscale analog)")
    d.add_argument("--benchmark", action="store_true")
    d.add_argument("--device-resident", dest="device_resident",
                   action="store_true",
                   help="with --benchmark: measure the device-resident "
                        "chip rate (the program alone, run back to back)")
    d.add_argument("--device", default="cuda",
                   help="torch device of the decoder (cuda, cuda:N, cpu; "
                        "default cuda; no fallback to the CPU)")
    d.set_defaults(func=_cmd_decode, bitexact=True)

    e = sub.add_parser("encode", help="encode raw video")
    e.add_argument("input")
    e.add_argument("-o", "--output", default="-")
    e.add_argument("-s", "--size", required=True, help="WxH")
    e.add_argument("--pix-fmt", default="gray")
    e.add_argument("--codec", default="ht", choices=["ht", "j2k"])
    e.add_argument("--pred", type=int, default=1,
                   help="1 = 5/3 reversible, 0 = 9/7-int (j2k only)")
    e.add_argument("--prog", default="lrcp",
                   choices=["lrcp", "rlcp", "rpcl", "pcrl", "cprl"])
    e.add_argument("--tile-width", type=int, default=256)
    e.add_argument("--tile-height", type=int, default=256)
    e.add_argument("--sop", action="store_true")
    e.add_argument("--eph", action="store_true")
    e.add_argument("--layer-rates", default=None)
    e.add_argument("--tp-interval", type=int, default=0,
                   help="packets per tile-part (0 = single tile-part)")
    e.add_argument("-q", "--quality", type=int, default=0)
    e.add_argument("--jp2", action="store_true")
    e.set_defaults(func=_cmd_encode)

    pr = sub.add_parser("probe", help="inspect a file (ffprobe analog)")
    pr.add_argument("input")
    pr.set_defaults(func=_cmd_probe)

    args = p.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
