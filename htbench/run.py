"""Run one cell of ``BENCHMARK.json`` once and print one JSON line.

    python -m htbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up makes the cell's K streams from the seed (or reads them from the
stream cache), builds ``ffmpeg_ht_tpu_torch.models.decoder.Decoder``
with the configuration's arguments on the card and warms it up on the
cell's own frames. The window then drives the traffic's entry for
`seconds` (``window.py``). After it, the card's peak memory is read,
the decoder is freed, and a seeded sample of the frames is held to the
configuration's plain reference. With ``--trace 0`` the line carries
the cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics,
read from host spans and a ``torch.profiler`` trace of the window, and
a breakdown. The numbers compared, each beside its limit, close the
line (``checks``) and standard error.

A run holds the host still: one thread for the numeric libraries and
torch's CPU work, the window's thread on one fixed core, and the objects
made by set-up frozen out of the garbage collector's passes.

Exits 2, printing no result, without a card (or with fewer than the
cell asks for), and 3 when ``jax``, ``jaxlib``, ``flax`` or
``ffmpeg_ht_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import os
import time

T_START = time.perf_counter()

# one thread for each numeric library: read when they load, below
ONE_THREAD = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
if __name__ == "__main__":
    os.environ.update({v: "1" for v in ONE_THREAD})

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from . import inputs, spec, window  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ffmpeg_ht_tpu")
CHECK_SHARE = 1 / 8          # of the frames after the first cycle
PICK_N = 1 << 18
CACHE_ENV = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
             "torch_extensions", "CUDA_CACHE_PATH": "cuda_cache"}


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def keep_rule(seed: int, k: int):
    """Which frames the check holds: the first cycle's K, and each later
    one with probability CHECK_SHARE, drawn from the seed."""
    pick = np.random.default_rng([seed % (1 << 64), 1 << 40]).random(
        PICK_N) < CHECK_SHARE
    return lambda j: j < k or (j < PICK_N and bool(pick[j]))


def pin_to_one_core() -> int:
    """Keep the calling thread on one fixed core, the last it may use
    (away from core 0, which takes most interrupts); returns it."""
    core = max(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {core})
    return core


ROUTES = ("v3_frames", "v2_frames", "host_frames")


def read_routes(dec) -> dict:
    """The decoder's route counters; None where it has none."""
    return {k: getattr(dec, k, None) for k in ROUTES}


def route_checks(before: dict, after: dict, returned: int) -> dict:
    """Frames of the window that the host decoded, and frames returned
    that no device route counted (all of them where a counter is
    missing): each has to be 0."""
    def grew(k):
        if before[k] is None or after[k] is None:
            return None
        return after[k] - before[k]
    host, v3, v2 = grew("host_frames"), grew("v3_frames"), grew("v2_frames")
    off = returned if v3 is None or v2 is None else max(0, returned - v3 - v2)
    return {"host_route_frames": {"value": returned if host is None else host,
                                  "limit": 0},
            "off_device_frames": {"value": off, "limit": 0}}


def program_decoder(cell, device):
    from ffmpeg_ht_tpu_torch.models.decoder import Decoder
    return Decoder(device=device, **cell.config["decoder"])


def check(cell, seed: int, rec) -> dict:
    """The numbers compared, each {"value", "limit"}: kept frames that
    differ from the reference, frames not returned one for one, and
    exceptions in the window (the route checks are ``route_checks``)."""
    ref = spec.module("references", cell.config["reference"])
    srcs = inputs.sources(cell.config, cell.traffic, seed)
    want = [ref.expected(s, cell.config["depth"]) for s in srcs]
    wrong, widest = 0, 0
    for j, fr in sorted(rec.kept.items()):
        n, wd = ref.judge(fr.planes, fr.width, fr.height,
                          want[j % len(want)])
        if n:
            wrong += 1
            widest = max(widest, wd if wd is not None else -1)
    log(f"checked {len(rec.kept)} of {len(rec.t_out)} frames against the "
        f"reference '{cell.config['reference']}': {wrong} differ, widest "
        f"difference {widest}")
    return {"wrong_frames": {"value": wrong, "limit": 0},
            "missing_frames": {"value": rec.miscounted, "limit": 0},
            "window_errors": {"value": int(rec.error is not None),
                              "limit": 0}}


def span_labels(cell) -> set:
    """The host spans that the cell's per-layer readers name (``SPANS``
    in each ``layers/<metric>.py``): only these are installed."""
    return {label for m in cell.per_layer
            for label in getattr(spec.module("layers", m["name"]),
                                 "SPANS", ())}


def is_correct(checks: dict, rec) -> bool:
    return bool(rec.kept) and all(v["value"] <= v["limit"]
                                  for v in checks.values())


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi: {e!r}"
    return out.replace("\n", " | ")


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             make_decoder=program_decoder, t_start: float = T_START,
             cache: bool = True, pending=None, pin: bool = False) -> dict:
    """One run of `cell`; returns the result line's object. `device`
    and `make_decoder(cell, device)` are the card and the program: tests
    and the control put others in their place. `pending`: the streams
    already started (``inputs.start_streams``). `pin`: warm-up and window
    on one core (``pin_to_one_core``)."""
    import torch

    from . import tracing

    entry = cell.traffic["entry"]
    per_call = int(cell.traffic["frames_per_call"])
    if pending is None:
        pending = inputs.start_streams(cell.name, cell.config, cell.traffic,
                                       seed, cache=cache)
    dec = make_decoder(cell, device)
    streams = pending.get()
    log(f"{cell.name}: {len(streams)} streams, "
        f"{sum(map(len, streams)) / len(streams) / 1e6:.3f} MB a frame "
        f"(at {time.perf_counter() - t_start:.1f} s)")
    if pin:
        log(f"window thread on core {pin_to_one_core()}")
    window.warm_up(entry, dec, streams, per_call)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    log(f"warmed up (at {time.perf_counter() - t_start:.1f} s)")
    keep = keep_rule(seed, len(streams))
    spans = tracing.Spans(spec.span_specs(span_labels(cell))) \
        if trace else None
    dtrace = tracing.DeviceTrace() if trace and cuda else None
    routes0 = read_routes(dec)
    gc.collect()
    gc.freeze()
    rec = window.WindowRecord()
    window.run(entry, dec, streams, seconds, per_call, keep, rec)
    rec.setup_s = rec.t0 - t_start
    gc.unfreeze()
    ops = dtrace.stop() if dtrace else []
    if spans:
        spans.remove()
    if cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(torch.device(device))
    else:
        peak = 0
    routes = read_routes(dec)
    del dec
    if cuda:
        torch.cuda.empty_cache()
    log(f"window: {len(rec.t_in)} frames handed in, {len(rec.t_out)} "
        f"returned in {rec.t_end - rec.t0:.3f} s; routes {routes}")
    print(json.dumps({"routes": routes}), flush=True)

    checks = check(cell, seed, rec)
    checks.update(route_checks(routes0, routes, len(rec.t_out)))
    correct = is_correct(checks, rec)
    failed = (checks["wrong_frames"]["value"] + rec.miscounted
              + checks["window_errors"]["value"]
              + checks["off_device_frames"]["value"])
    metrics, dev = {}, {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(torch.device(device))
        if cuda else "cpu",
        "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(rec.t_in),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        peak_bw = spec.peaks().get(dev["kind"], {}).get("hbm_bytes_per_s")
        per_frame_out = (cell.config["height"] * cell.config["width"]
                         * cell.config["components"]
                         * (1 if cell.config["depth"] <= 8 else 2))
        td = tracing.TraceData(
            t0=rec.t0, t1=rec.t_end, frames=len(rec.t_out),
            spans=spans.records, absent=spans.absent, device_ops=ops,
            stream_bytes=sum(len(streams[j % len(streams)])
                             for j in range(len(rec.t_out))),
            output_bytes=per_frame_out * len(rec.t_out),
            hbm_bytes_per_s=peak_bw)
        for m in cell.per_layer:
            v = spec.module("layers", m["name"]).read(td)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"] = td.busy_s() or 0.0
        dev["window_s"] = td.window_s
        result["breakdown"] = {"device_ops": td.top_device_ops(),
                               "idle_gaps": td.idle_by_host_span()}
        if spans.absent:
            log(f"spans with a target gone: {sorted(spans.absent)}")
    else:
        for m in cell.end_to_end:
            v = spec.module("end_to_end", m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m htbench.run",
                                description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    for var, sub in CACHE_ENV.items():
        os.environ[var] = os.path.join(spec.ROOT, "build", "htbench", sub)
    # the streams are made while torch loads and the card starts
    pending = inputs.start_streams(cell.name, cell.config, cell.traffic,
                                   args.seed)
    try:
        import torch
        torch.set_num_threads(1)
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda} (at "
            f"{time.perf_counter() - T_START:.1f} s)")
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell.chips:
            log(f"{cell.name} needs {cell.chips} CUDA card(s); "
                f"is_available={torch.cuda.is_available()}, "
                f"device_count={torch.cuda.device_count()}")
            return 2
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          pending=pending, pin=True)
    finally:
        pending.close()
    log(f"card: {_card_line()}")
    bad = forbidden_modules()
    if bad:
        log(f"loaded in this process after the window: {bad}")
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
