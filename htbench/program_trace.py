"""The program's own spans and counters over a traced window
(``ffmpeg_ht_tpu_torch.utils.trace``), for the readers in ``layers/``
that read them.

Just before the window opens, the harness asks each of the cell's
readers for its ``SPANS``; a reader of the program's tracer answers
through ``hook`` (its module ``__getattr__``), which calls
``open_window``: the tracer is turned on, its counters, the kernel
launches and the clock offset are noted. The first such reader after the
window calls ``window(t)``: the spans are drained, the tracer turned off,
the counters' growth taken, and the spans added to ``t.spans`` under
their own names (seconds of ``perf_counter``), so that the breakdown's
idle gaps are split by the innermost span of either kind. A program
without the tracer (an older commit), or a window in which it recorded
no entry call (the control), leaves every such reader None.

The clock offset, wall time minus ``perf_counter``, is the one that maps
the device trace onto the host clock; its change between the window's
opening and the first read is printed on standard error as
``clock_drift_us``.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

ENTRY_SPAN = "dispatch"      # every entry call of the decoder opens one


@dataclass
class Window:
    """What the program's tracer recorded in one traced window."""
    spans: List[Tuple[str, float, float, int, int]] = field(
        default_factory=list)           # (name, start s, end s, call, parent)
    counters: Dict[str, int] = field(default_factory=dict)
    launches: int = 0
    clock_drift_us: float = 0.0


_open: Optional[dict] = None
_last: Optional[Tuple[object, Optional[Window]]] = None


def _tracer():
    try:
        from ffmpeg_ht_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def _offset_ns() -> int:
    return time.time_ns() - time.perf_counter_ns()


def open_window() -> None:
    """Turn the program's tracer on with an empty list and note where its
    counters stand; calling it again before the window restarts it."""
    global _open, _last
    trace = _tracer()
    _last = None
    if trace is None:
        _open = None
        return
    trace.drain()
    trace.enable()
    _open = {"counters": dict(trace.counters), "launches": trace.launches(),
             "offset_ns": _offset_ns()}


def hook(name: str):
    """A reader module's ``__getattr__``: its ``SPANS`` opens the window
    (it names no wrapped span)."""
    if name == "SPANS":
        open_window()
        return ()
    raise AttributeError(name)


def window(t) -> Optional[Window]:
    """The program's record of the traced window `t` (a
    ``tracing.TraceData``), None where the program has no tracer or it
    recorded no entry call; read once a window, then kept."""
    global _open, _last
    if _last is not None and _last[0] is t:
        return _last[1]
    trace, opened, _open = _tracer(), _open, None
    w = None
    if trace is not None and opened is not None:
        raw = trace.drain()
        trace.disable()
        drift = (_offset_ns() - opened["offset_ns"]) / 1e3
        spans = [(n, s / 1e9, e / 1e9, c, p) for n, s, e, c, p in raw if e]
        if any(n == ENTRY_SPAN for n, *_ in spans):
            w = Window(spans=spans,
                       counters={k: v - opened["counters"].get(k, 0)
                                 for k, v in trace.counters.items()},
                       launches=trace.launches() - opened["launches"],
                       clock_drift_us=drift)
            t.spans.extend((n, s, e) for n, s, e, _c, _p in spans)
            print(f"# clock_drift_us {drift} (wall clock minus perf_counter,"
                  f" first read after the window minus its opening)",
                  file=sys.stderr, flush=True)
    _last = (t, w)
    return w


def span_ms_per_frame(t, name: str) -> Optional[float]:
    """The program's span `name` in the window, ms per frame returned."""
    w = window(t)
    if w is None or t.frames == 0:
        return None
    return 1e3 * sum(e - s for n, s, e, _c, _p in w.spans
                     if n == name) / t.frames
