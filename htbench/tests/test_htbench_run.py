"""A whole run on the CPU at a tiny size: the result line's keys, the
check passing on the program, and coming out false on the control and on
the program broken underneath (an altered answer, a stale frame, half a
batch left out). The harness's look for a card is the only part
skipped."""

import json
import subprocess
import sys

import pytest

from htbench import control, run, spec
from htbench.tests.tiny import tiny_cell

SEED = 2 ** 31 + 99
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device",
               "checks"}


def _run(cell, trace=False, **kw):
    """A 2 s window: the tiny c3 frame takes up to 0.5 s on the CPU, and a
    stale frame shows only from the second frame on."""
    return run.run_cell(cell, SEED, 2.0, trace, device="cpu", cache=False,
                        **kw)


@pytest.mark.parametrize("like", ["c3-stream-natural", "c1-batch16-natural"])
def test_sound_run_is_correct_and_keeps_to_the_line(like):
    cell = tiny_cell(like, per_call=2 if "batch" in like else None)
    r = _run(cell)
    assert r["correct"] is True and r["failed"] == 0
    assert set(r) == RESULT_KEYS and list(r)[-1] == "checks"
    assert r["attempted"] >= 1
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(r)


def test_traced_run_reports_per_layer_metrics_and_breakdown():
    cell = tiny_cell("c3-stream-natural")
    r = _run(cell, trace=True)
    assert set(r) == RESULT_KEYS | {"breakdown"}
    # the CPU has no device trace: the device's readers return nothing
    assert set(r["metrics"]) == {"host_parse_ms", "host_lane_ms",
                                 "host_write_ms"}
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(r["breakdown"]["idle_gaps"]) <= 10
    assert {"busy_s", "window_s"} <= set(r["device"])


@pytest.mark.parametrize("like", ["c3-stream-natural", "c1-batch16-natural"])
def test_control_at_lower_precision_is_not_correct(like):
    cell = tiny_cell(like, per_call=2 if "batch" in like else None)
    r = _run(cell, make_decoder=lambda c, _d: control.ControlDecoder(c, SEED))
    assert r["correct"] is False
    # every frame of the first cycle is checked, and every one differs
    assert r["checks"]["wrong_frames"]["value"] >= min(4, r["attempted"])


def _altered(monkeypatch):
    from ffmpeg_ht_tpu_torch.models.decoder import Decoder
    orig = Decoder._split_frames

    def split(self, *a, **k):
        frames = orig(self, *a, **k)
        for fr in frames:
            fr.planes[0].flat[17] ^= 1
        return frames
    monkeypatch.setattr(Decoder, "_split_frames", split)


def _stale(monkeypatch):
    from ffmpeg_ht_tpu_torch.models.decoder import Decoder
    orig_stream, orig_batch = Decoder.decode_stream, Decoder.decode_batch
    last = {}

    def stream(self, streams, *a, **k):
        for fr in orig_stream(self, streams, *a, **k):
            yield last.setdefault("frame", fr)

    def batch(self, streams, *a, **k):
        return last.setdefault("frames", orig_batch(self, streams, *a, **k))
    monkeypatch.setattr(Decoder, "decode_stream", stream)
    monkeypatch.setattr(Decoder, "decode_batch", batch)


def _half_batch(monkeypatch):
    from ffmpeg_ht_tpu_torch.models.decoder import Decoder
    orig = Decoder.decode_batch

    def batch(self, streams, *a, **k):
        half = orig(self, streams[:len(streams) // 2], *a, **k)
        return (half * 2)[:len(streams)]
    monkeypatch.setattr(Decoder, "decode_batch", batch)


FAULTS = [("c3-stream-natural", _altered), ("c3-stream-natural", _stale),
          ("c1-batch16-natural", _altered), ("c1-batch16-natural", _stale),
          ("c1-batch16-natural", _half_batch)]


@pytest.mark.parametrize("like,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_broken_program_is_not_correct(like, fault, monkeypatch):
    cell = tiny_cell(like, per_call=2 if "batch" in like else None)
    fault(monkeypatch)
    r = _run(cell)
    assert r["attempted"] >= 2
    assert r["correct"] is False
    assert r["checks"]["wrong_frames"]["value"] > 0


@pytest.mark.parametrize("like", ["c3-stream-natural", "c1-batch16-natural"])
def test_frames_decoded_on_the_host_are_not_correct(like, monkeypatch):
    """Lossless frames from the decoder's host route are right, but not
    the card's work: the route counters fail the run."""
    from ffmpeg_ht_tpu_torch.models import decoder
    monkeypatch.setattr(decoder, "_supported_on_device", lambda *a: False)
    monkeypatch.setattr(decoder.Decoder, "_fast_launch", lambda *a: None)
    monkeypatch.setattr(decoder.Decoder, "_fast_batch", lambda *a: None)
    cell = tiny_cell(like, per_call=2 if "batch" in like else None)
    r = _run(cell)
    assert r["correct"] is False
    assert r["checks"]["wrong_frames"]["value"] == 0
    assert r["checks"]["host_route_frames"]["value"] == r["attempted"]
    assert r["checks"]["off_device_frames"]["value"] == r["attempted"]


def test_route_checks_read_the_window_only():
    before = {"v3_frames": 4, "v2_frames": 0, "host_frames": 1}
    after = {"v3_frames": 14, "v2_frames": 2, "host_frames": 1}
    c = run.route_checks(before, after, 12)
    assert c == {"host_route_frames": {"value": 0, "limit": 0},
                 "off_device_frames": {"value": 0, "limit": 0}}
    c = run.route_checks(before, dict(after, host_frames=3), 14)
    assert c["host_route_frames"]["value"] == 2
    assert c["off_device_frames"]["value"] == 2
    gone = dict.fromkeys(after)
    c = run.route_checks(gone, gone, 12)
    assert c["host_route_frames"]["value"] == 12
    assert c["off_device_frames"]["value"] == 12


def test_window_error_is_not_correct(monkeypatch):
    from ffmpeg_ht_tpu_torch.models.decoder import Decoder
    from ffmpeg_ht_tpu_torch.utils.errors import InvalidData
    orig, calls = Decoder._split_frames, []

    def broken(self, *a, **k):
        calls.append(1)
        if len(calls) > 4:          # the warm-up's 4 frames pass
            raise InvalidData("broken on purpose")
        return orig(self, *a, **k)
    monkeypatch.setattr(Decoder, "_split_frames", broken)
    r = _run(tiny_cell("c3-stream-natural"))
    assert r["correct"] is False
    assert r["checks"]["window_errors"]["value"] == 1


def test_no_card_exits_without_a_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs its absence")
    assert run.main(["--workload", "c3-stream-natural", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_whole_import_graph_is_free_of_jax(tmp_path):
    """A fresh process imports every harness module and makes a tiny run;
    no loaded module's top-level name is jax, jaxlib, flax or
    ffmpeg_ht_tpu (compared whole: ffmpeg_ht_tpu_torch is the port)."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import htbench\n"
        "for m in pkgutil.walk_packages(htbench.__path__, 'htbench.'):\n"
        "    if '.tests' not in m.name:\n"
        "        importlib.import_module(m.name)\n"
        "from htbench import run\n"
        "from htbench.tests.tiny import tiny_cell\n"
        "r = run.run_cell(tiny_cell('c3-stream-natural'), 5, 0.3, True,\n"
        "                 device='cpu', cache=False)\n"
        "assert r['correct'], r\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print('FORBIDDEN', run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout
    tops = eval(out.stdout.splitlines()[-2])
    assert "ffmpeg_ht_tpu_torch" in tops
    assert not {"jax", "jaxlib", "flax", "ffmpeg_ht_tpu"} & set(tops)
