"""``BENCHMARK.json`` and the files it names, found by name.

Nothing here imports the program or torch: spawned encoder workers
import this module too.
"""

from __future__ import annotations

import importlib
import json
import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG_DIR)
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")
PACKAGE = __name__.rsplit(".", 1)[0]


def _json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files loaded."""
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_config(path: str) -> dict:
    """A configuration file, its path taken from the repository root."""
    return _json(os.path.join(ROOT, path))


def load_traffic(name: str) -> dict:
    return _json(os.path.join(PKG_DIR, "traffic", f"{name}.json"))


def load_cell(name: str) -> Cell:
    """The cell `name` of ``BENCHMARK.json``; raises KeyError naming the
    cells there are."""
    bench = _json(BENCHMARK)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return Cell(name=name, config=load_config(configs[w["config"]]["file"]),
                traffic=load_traffic(w["traffic"]),
                chips=int(w["chips"]),
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])


def module(kind: str, name: str):
    """``htbench.<kind>.<name>``, a file of its own under `kind`."""
    return importlib.import_module(f"{PACKAGE}.{kind}.{name}")


def span_specs(labels: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """``spans/<label>.json`` by label: those of `labels` (a label
    without a file maps to {}, a span with no target), or every one."""
    d = os.path.join(PKG_DIR, "spans")
    if labels is None:
        labels = [f[:-5] for f in sorted(os.listdir(d)) if f.endswith(".json")]
    out = {}
    for label in sorted(labels):
        path = os.path.join(d, f"{label}.json")
        out[label] = _json(path) if os.path.exists(path) else {}
    return out


def peaks() -> Dict[str, dict]:
    """The table of published peaks, by the card's name."""
    return _json(os.path.join(PKG_DIR, "peaks.json"))
