"""BENCHMARK.json keeps to its contract, and every name in it finds its
file: configurations, traffic mixes, content kinds, references and the
readers of every metric."""

import json
import os
import re

import pytest

from htbench import spec, window

with open(spec.BENCHMARK) as _f:
    BENCH = json.load(_f)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def test_top_level_keys_command_and_paths():
    assert set(BENCH) == TOP_KEYS
    assert "htbench" in BENCH["paths"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert BENCH["command"][-2:] == ["-m", "htbench.run"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_under_paths_and_found(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"])
    assert cfg["file"].startswith("htbench/configs/")
    c = spec.load_config(cfg["file"])
    assert c["source"] == cfg["source"] and c["reduced"] == cfg["reduced"]
    assert 1 <= len(cfg["source"]) <= 200 and 1 <= len(cfg["why"]) <= 200
    spec.module("references", c["reference"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_finds_config_traffic_and_content(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    cell = spec.load_cell(w["name"])
    assert cell.traffic["entry"] in window.ENTRIES
    spec.module("content", cell.traffic["content"])
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer


def test_each_pair_of_config_and_traffic_once():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {c["name"] for c in BENCH["configs"]} == {p[0] for p in pairs}


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_every_metric_has_its_reader(kind):
    d = "end_to_end" if kind == "end_to_end" else "layers"
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH[kind]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert callable(spec.module(d, m["name"]).read)
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
            assert m["layer"] and "\n" not in m["layer"]


def test_unknown_cell_names_the_cells_there_are():
    with pytest.raises(KeyError, match="c3-stream-natural"):
        spec.load_cell("no-such-cell")


def test_span_files_name_program_functions():
    specs = spec.span_specs()
    assert {"host_parse", "host_lane", "host_write"} <= set(specs)
    for s in specs.values():
        for t in s.get("wrap", []) + s.get("wrap_returned", []):
            assert t.startswith("ffmpeg_ht_tpu_torch.") and ":" in t


def test_file_names_are_made_of_name_characters():
    for dirpath, _dirs, files in os.walk(spec.PKG_DIR):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), spec.ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
