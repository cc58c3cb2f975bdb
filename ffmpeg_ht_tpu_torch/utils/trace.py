"""Spans and counters of the decoder's host path.

    from ffmpeg_ht_tpu_torch.utils import trace
    trace.enable()
    frames = dec.decode_batch(streams)
    spans = trace.drain()      # [(name, start_ns, end_ns, call, parent)]
    trace.disable()

A span times one stage where the work happens (``Decoder`` and the lane
build, the program call, the fetch and the write), as a ``with
span(name)`` block or a function decorated ``timed(name)``; ``start_ns`` and
``end_ns`` are ``time.perf_counter_ns()``. Each entry call of the decoder
takes a fresh call id (``new_call``) and opens its root spans with it
(``dispatch``, then ``finish`` when its output is taken); a span opened
below another takes its call id, and ``parent`` is the index of that span
in the list (-1 for a root). Tracing is off by default and only
``enable`` turns it on: off, ``span`` returns one shared object that does
nothing, so a span site costs a call and a ``with``, no clock read and no
allocation. Nothing synchronises the device, and nothing is written
anywhere; ``drain`` hands the spans over and clears the list. One thread:
the decoder's own.

Counters (``count``) always count, as the kernel wrappers' ``.launches``
attributes do; ``launches`` sums those attributes, which stay the one
source of launch counts.
"""

from __future__ import annotations

import functools
import importlib
import time
from typing import Dict, List, Tuple

# the kernel wrappers whose ``.launches`` count CUDA kernel launches
KERNELS = (
    ("ffmpeg_ht_tpu_torch.ops.ht_scan", ("ht_vlc_pass", "ht_magsgn_pass")),
    ("ffmpeg_ht_tpu_torch.ops.ht_refine", ("ht_sigprop_pass",
                                           "ht_magref_pass")),
    ("ffmpeg_ht_tpu_torch.ops.mct_cuda", ("rct_writeframe", "ict_writeframe",
                                          "plane_writeframe")),
    ("ffmpeg_ht_tpu_torch.ops.wirepack", ("pack_words",)),
    ("ffmpeg_ht_tpu_torch.ops.coef_cuda", ("coef_mosaic", "bucket_scatter")),
    ("ffmpeg_ht_tpu_torch.ops.dwt_cuda", ("dwt_lift", "dwt_small")),
)

Span = Tuple[str, int, int, int, int]

counters: Dict[str, int] = {}
_on = False
_spans: List[list] = []
_stack: List[Tuple[list, int]] = []     # the open spans: (record, index)
_calls = 0


class _Off:
    """The span of a tracer that is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "call", "rec")

    def __init__(self, name: str, call):
        self.name, self.call = name, call

    def __enter__(self):
        parent, call = -1, self.call
        if _stack:
            prec, parent = _stack[-1]
            if call is None:
                call = prec[3]
        self.rec = [self.name, time.perf_counter_ns(), 0,
                    _calls if call is None else call, parent]
        _stack.append((self.rec, len(_spans)))
        _spans.append(self.rec)
        return self

    def __exit__(self, *exc):
        self.rec[2] = time.perf_counter_ns()
        if _stack and _stack[-1][0] is self.rec:
            _stack.pop()
        return False


def span(name: str, call=None):
    """A context manager timing `name`. `call`: the call id of a root
    span; by default the open span's, or the latest ``new_call``'s."""
    return _On(name, call) if _on else _OFF


def timed(name: str):
    """Decorator: each call of the function is a span `name`, opened
    inside it (so inside any wrapper put around the function later)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*a, **k):
            if not _on:
                return fn(*a, **k)
            with _On(name, None):
                return fn(*a, **k)
        return inner
    return wrap


def new_call() -> int:
    """A fresh call id, for an entry call's root spans."""
    global _calls
    _calls += 1
    return _calls


def count(name: str, n: int = 1) -> None:
    counters[name] = counters.get(name, 0) + n


def launches() -> int:
    """CUDA kernel launches so far: the sum of the kernel wrappers'
    ``.launches``."""
    total = 0
    for mod, names in KERNELS:
        m = importlib.import_module(mod)
        total += sum(getattr(m, n).launches for n in names)
    return total


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def drain() -> List[Span]:
    """The spans recorded since the last drain, in the order they opened;
    clears the list. A span still open has end 0."""
    global _spans
    out, _spans = _spans, []
    _stack.clear()
    return [tuple(r) for r in out]
