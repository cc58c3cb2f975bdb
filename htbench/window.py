"""The measured window: a closed loop over the cell's K streams through
the entry that its traffic names.

``decode_stream``: one generator hands the streams in, cycling over the
K of them, and stamps each as the decoder pulls it; every frame the
decoder yields is stamped as it comes. ``decode_batch``: one call of F
streams after another, each frame stamped with its call's start and
return. In both, no stream is handed in once `seconds` have passed
since the first, and what is in flight then runs to its end. Frame j is
made from source j mod K. A sample of the frames, drawn from the seed,
is kept for the check after the window; the rest are dropped as they
come.
"""

from __future__ import annotations

import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


@dataclass
class WindowRecord:
    t0: float = 0.0              # the first stream handed in
    t_end: float = 0.0           # the last frame returned
    setup_s: float = 0.0
    t_in: List[float] = field(default_factory=list)
    t_out: List[float] = field(default_factory=list)
    kept: Dict[int, object] = field(default_factory=dict)
    miscounted: int = 0          # frames returned too few or too many
    error: Optional[str] = None


def _stream(dec, streams, seconds, keep, rec, per_call):
    k = len(streams)

    def feed():
        i = 0
        while True:
            now = time.perf_counter()
            if i == 0:
                rec.t0 = now
            elif now - rec.t0 >= seconds:
                return
            rec.t_in.append(now)
            yield streams[i % k]
            i += 1

    j = 0
    for frame in dec.decode_stream(feed()):
        rec.t_out.append(time.perf_counter())
        if keep(j):
            rec.kept[j] = frame
        j += 1
    rec.miscounted += abs(len(rec.t_in) - j)


def _batch(dec, streams, seconds, keep, rec, per_call):
    k = len(streams)
    i = 0
    rec.t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        if i and t - rec.t0 >= seconds:
            return
        rec.t_in.extend([t] * per_call)
        frames = dec.decode_batch([streams[(i + f) % k]
                                   for f in range(per_call)])
        t_ret = time.perf_counter()
        rec.miscounted += abs(len(frames) - per_call)
        for f, frame in enumerate(frames[:per_call]):
            rec.t_out.append(t_ret)
            if keep(i + f):
                rec.kept[i + f] = frame
        i += per_call


ENTRIES = {"decode_stream": _stream, "decode_batch": _batch}


def run(entry: str, dec, streams, seconds: float, per_call: int,
        keep: Callable[[int], bool], rec: WindowRecord) -> WindowRecord:
    """Drive `entry` of `dec` for `seconds`; an exception ends the
    window and is recorded in ``rec.error``."""
    try:
        ENTRIES[entry](dec, streams, seconds, keep, rec, per_call)
    except Exception as e:  # noqa: BLE001 - recorded; the run is not correct
        traceback.print_exc(file=sys.stderr)
        rec.error = repr(e)[:500]
    rec.t_end = max(rec.t_out) if rec.t_out else rec.t0
    return rec


def warm_up(entry: str, dec, streams, per_call: int) -> None:
    """Every frame of the cycle once through the entry, so that each
    program the window calls is built and its kernels loaded."""
    if entry == "decode_stream":
        for _ in dec.decode_stream(iter(streams)):
            pass
        return
    for i in range(0, len(streams), per_call):
        dec.decode_batch([streams[(i + f) % len(streams)]
                          for f in range(per_call)])
