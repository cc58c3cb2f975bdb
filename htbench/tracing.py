"""The traced run: host spans from wrapped program functions, device
operations from ``torch.profiler``, and the arithmetic the per-layer
readers share.

A span is recorded by wrapping a program function where the decoder
looks it up (``spans/<label>.json``: ``module:attribute``), with the
host clock and no device synchronisation. A target that is gone leaves
its label absent, and every reader of that label returns None. The
profiler traces CUDA activity only; its timestamps are Unix nanoseconds,
mapped onto ``time.perf_counter`` by the offset read when the window
opens.
"""

from __future__ import annotations

import functools
import importlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from . import spec

# host<->device copies: device activity, but not the device program
COPY_PREFIXES = ("Memcpy HtoD", "Memcpy DtoH", "Memcpy PtoP")


def _resolve(target: str):
    """(owner, attribute name) of ``module:Attr.path``; raises
    AttributeError or ImportError when it is gone."""
    mod, path = target.split(":")
    owner = importlib.import_module(mod)
    names = path.split(".")
    for n in names[:-1]:
        owner = getattr(owner, n)
    getattr(owner, names[-1])
    return owner, names[-1]


def _timed(fn, label, rec):
    @functools.wraps(fn)
    def inner(*a, **k):
        t = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            rec.append((label, t, time.perf_counter()))
    return inner


def _timed_returned(fn, label, rec):
    @functools.wraps(fn)
    def inner(*a, **k):
        wait = fn(*a, **k)

        def timed_wait():
            t = time.perf_counter()
            try:
                return wait()
            finally:
                rec.append((label, t, time.perf_counter()))
        return timed_wait
    return inner


class Spans:
    """Installs the wrappers of `specs` (label -> ``spans/<label>.json``;
    every file there by default); ``remove`` puts every original back."""

    def __init__(self, specs: Optional[Dict[str, dict]] = None):
        self.records: List[Tuple[str, float, float]] = []
        self.absent: Set[str] = set()
        self._saved = []
        for label, s in (spec.span_specs() if specs is None
                         else specs).items():
            targets = [(t, _timed) for t in s.get("wrap", [])] + \
                [(t, _timed_returned) for t in s.get("wrap_returned", [])]
            found = []
            if not targets:                 # no file names this label
                self.absent.add(label)
            for target, how in targets:
                try:
                    found.append((_resolve(target), how))
                except (ImportError, AttributeError, ValueError):
                    self.absent.add(label)
            if label in self.absent:
                continue
            for (owner, name), how in found:
                # None: a method the class inherits, deleted again after
                self._saved.append((owner, name, vars(owner).get(name)))
                setattr(owner, name, how(getattr(owner, name), label,
                                         self.records))

    def remove(self) -> None:
        for owner, name, orig in reversed(self._saved):
            if orig is None:
                delattr(owner, name)
            else:
                setattr(owner, name, orig)
        self._saved.clear()


def _busy_intervals(intervals):
    """The union of (start, end) intervals, as disjoint [start, end]."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_s(intervals) -> float:
    """Seconds covered by the union of (start, end) intervals."""
    return sum(e - s for s, e in _busy_intervals(intervals))


@dataclass
class TraceData:
    """What a traced window recorded, in seconds of ``perf_counter``."""
    t0: float
    t1: float
    frames: int
    spans: List[Tuple[str, float, float]] = field(default_factory=list)
    absent: Set[str] = field(default_factory=set)
    device_ops: List[Tuple[str, float, float]] = field(default_factory=list)
    stream_bytes: int = 0
    output_bytes: int = 0
    hbm_bytes_per_s: Optional[float] = None

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def span_ms_per_frame(self, label: str) -> Optional[float]:
        """The label's span time in the window, ms per frame; None when
        the label is absent or nothing was decoded."""
        if label in self.absent or self.frames == 0:
            return None
        return 1e3 * sum(e - s for lb, s, e in self.spans
                         if lb == label) / self.frames

    def busy_s(self, program_only: bool = False) -> Optional[float]:
        """Seconds of the window in which a device operation ran (with
        `program_only`, one that is not a copy between host and device);
        None when the trace holds none."""
        ops = [(max(s, self.t0), min(e, self.t1))
               for n, s, e in self.device_ops
               if not (program_only and n.startswith(COPY_PREFIXES))]
        ops = [(s, e) for s, e in ops if e > s]
        return union_s(ops) if ops else None

    def top_device_ops(self, n: int = 10):
        per: Dict[str, float] = {}
        for name, s, e in self.device_ops:
            per[name] = per.get(name, 0.0) + (e - s)
        return sorted(([k, v] for k, v in per.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_by_host_span(self, n: int = 10):
        """The device's idle time in the window, split by the innermost
        host span open at the time ("loop" where none is: the
        benchmark's own loop and the decoder's glue), longest first."""
        busy = _busy_intervals([(s, e) for _, s, e in self.device_ops])
        gaps, cur = [], self.t0
        for s, e in busy:
            if s > cur:
                gaps.append((cur, min(s, self.t1)))
            cur = max(cur, e)
        if cur < self.t1:
            gaps.append((cur, self.t1))
        # elementary segments between span boundaries, innermost label
        bounds = sorted([(s, 0, i) for i, (_, s, _e) in enumerate(self.spans)]
                        + [(e, 1, i) for i, (_, _s, e) in
                           enumerate(self.spans)])
        segs, open_, last = [], [], self.t0
        for t, kind, i in bounds:
            if t > last:
                label = self.spans[open_[-1]][0] if open_ else "loop"
                segs.append((last, t, label))
                last = t
            if kind == 0:
                open_.append(i)
            else:
                open_.remove(i)
        segs.append((last, self.t1, "loop"))
        per: Dict[str, float] = {}
        j = 0
        for gs, ge in gaps:
            while j < len(segs) and segs[j][1] <= gs:
                j += 1
            k = j
            while k < len(segs) and segs[k][0] < ge:
                ov = min(ge, segs[k][1]) - max(gs, segs[k][0])
                if ov > 0:
                    per[segs[k][2]] = per.get(segs[k][2], 0.0) + ov
                k += 1
        return sorted(([k, v] for k, v in per.items()),
                      key=lambda kv: -kv[1])[:n]


class DeviceTrace:
    """``torch.profiler`` over CUDA activity; ``stop`` returns the
    device operations as (name, start, end) in perf_counter seconds."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        # Unix ns (the profiler's clock) minus perf_counter ns
        self.offset_ns = time.time_ns() - time.perf_counter_ns()

    def stop(self):
        import torch
        from torch.autograd import DeviceType
        torch.cuda.synchronize()
        self._prof.stop()
        res = self._prof.profiler.kineto_results
        ops = []
        for e in res.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            s = (e.start_ns() - self.offset_ns) / 1e9
            ops.append((e.name(), s, s + e.duration_ns() / 1e9))
        return ops
