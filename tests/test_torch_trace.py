"""The port's spans and counters (``ffmpeg_ht_tpu_torch/utils/trace.py``)
on the CPU, and the benchmark's readers of them (``htbench/layers``,
``htbench/program_trace.py``) on synthetic windows.

Off, the tracer records nothing; on, each entry call of ``Decoder`` opens
a ``dispatch`` and a ``finish`` span under its own call id, with the
lane build, upload, program call, fetch and write below them. Small
streams only: 96x128 gray, ``nreslevels=3``, 32x32 codeblocks.
"""

import numpy as np
import pytest

from ffmpeg_ht_tpu_torch.codestream.parser import parse_codestream
from ffmpeg_ht_tpu_torch.models import encoder
from ffmpeg_ht_tpu_torch.models import fastpath as FP
from ffmpeg_ht_tpu_torch.models.decoder import Decoder
from ffmpeg_ht_tpu_torch.utils import trace
from htbench import program_trace, spec, tracing

ENC = dict(nreslevels=3, log2_cblk_width=5, log2_cblk_height=5)
ENTRIES = ("decode_stream", "decode_batch")
# each span the v3 route records a call, and the span it opens under
PARENT = {"dispatch": None, "parse": "dispatch", "lane_cols": "dispatch",
          "lane_args": "dispatch", "upload": "dispatch",
          "launch": "dispatch", "finish": None, "fetch": "finish",
          "write": "finish"}


def _gray(seed):
    return np.random.default_rng(seed).integers(0, 256, (96, 128),
                                                dtype=np.uint8)


@pytest.fixture(scope="module")
def frames():
    imgs = [_gray(s) for s in (1, 2, 3)]
    return imgs, [encoder.encode_frame_htj2k(x, **ENC) for x in imgs]


@pytest.fixture
def tracer():
    """The tracer on with an empty list; off again afterwards."""
    trace.drain()
    trace.enable()
    yield trace
    trace.disable()
    trace.drain()


def _decode(dec, entry, streams):
    if entry == "decode_stream":
        return list(dec.decode_stream(streams))
    return dec.decode_batch(streams)


@pytest.fixture(scope="module")
def recorded(frames):
    """{entry: (the spans of one warm call of it, the frames, sources)}."""
    imgs, streams = frames
    out = {}
    for entry in ENTRIES:
        dec = Decoder(device="cpu")
        _decode(dec, entry, streams)            # builds outside the record
        trace.drain()
        trace.enable()
        try:
            got = _decode(dec, entry, streams)
        finally:
            trace.disable()
        out[entry] = (trace.drain(), got, imgs)
    return out


# ---- the tracer alone

def test_span_off_is_one_shared_object_and_records_nothing():
    trace.drain()
    a, b = trace.span("x"), trace.span("y", 7)
    assert a is b
    with a:
        with b:
            pass
    assert trace.drain() == []


def test_spans_nest_under_the_call_id_of_their_root(tracer):
    c1, c2 = tracer.new_call(), tracer.new_call()
    assert c2 == c1 + 1
    with tracer.span("dispatch", c1):
        with tracer.span("parse"):
            pass
    with tracer.span("finish", c1):
        with tracer.span("write"):
            pass
    spans = tracer.drain()
    assert [s[0] for s in spans] == ["dispatch", "parse", "finish", "write"]
    assert [s[3] for s in spans] == [c1] * 4
    assert [s[4] for s in spans] == [-1, 0, -1, 2]
    assert all(0 < s[1] <= s[2] for s in spans)
    assert tracer.drain() == []


def test_timed_function_is_a_span_inside_any_wrapper(tracer):
    @trace.timed("work")
    def work(x):
        return x + 1

    with tracer.span("outer", 5):
        assert work(1) == 2
    (outer, inner) = tracer.drain()
    assert inner[0] == "work" and inner[3] == 5 and inner[4] == 0
    assert outer[1] <= inner[1] <= inner[2] <= outer[2]
    trace.disable()
    assert work(2) == 3 and trace.drain() == []


def test_counters_count_with_the_tracer_off():
    before = trace.counters.get("test_counter", 0)
    trace.count("test_counter")
    trace.count("test_counter", 4)
    assert trace.counters["test_counter"] == before + 5


def test_launches_sums_the_kernel_wrappers_counts(monkeypatch):
    import importlib
    before = trace.launches()
    wrappers = [getattr(importlib.import_module(m), n)
                for m, names in trace.KERNELS for n in names]
    assert len(wrappers) == 12
    for i, w in enumerate(wrappers):
        monkeypatch.setattr(w, "launches", w.launches + i + 1)
    assert trace.launches() - before == sum(range(1, 13))


# ---- both entries on the CPU

@pytest.mark.parametrize("entry", ENTRIES)
def test_tracer_off_records_no_span(frames, entry):
    imgs, streams = frames
    trace.drain()
    got = _decode(Decoder(device="cpu"), entry, streams)
    assert trace.drain() == []
    assert all(np.array_equal(f.planes[0], x) for f, x in zip(got, imgs))


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("name", sorted(PARENT))
def test_entry_records_the_span_under_its_call(recorded, entry, name):
    spans, got, imgs = recorded[entry]
    assert all(np.array_equal(f.planes[0], x) for f, x in zip(got, imgs))
    calls = sorted({s[3] for s in spans})
    # one call id for each call: three for the stream, one for the batch
    assert len(calls) == (3 if entry == "decode_stream" else 1)
    for call in calls:
        mine = [s for s in spans if s[0] == name and s[3] == call]
        assert mine, f"no {name} span in call {call}"
        for s in mine:
            assert 0 < s[1] <= s[2]
            want = PARENT[name]
            if want is None:
                assert s[4] == -1
            else:
                assert spans[s[4]][0] == want and spans[s[4]][3] == call
    roots = [s for s in spans if s[4] == -1]
    assert sorted(s[0] for s in roots) == sorted(["dispatch", "finish"]
                                                 * len(calls))


def test_stream_finishes_a_frame_after_the_next_ones_dispatch(recorded):
    spans = recorded["decode_stream"][0]
    first = min(s[3] for s in spans)
    ends = {s[3]: s[2] for s in spans if s[0] == "dispatch"}
    fin = next(s for s in spans if s[0] == "finish" and s[3] == first)
    # depth 3: the third frame is dispatched before the first is taken
    assert fin[1] >= max(ends.values())


def _long_tail_stream():
    """One noisy 16x16 codeblock among 63 near-empty ones (no DWT): its
    stream is past twice the 98th percentile's width, so the policy sends
    it to the scalar oracle."""
    img = np.full((128, 128), 128, np.uint8)
    img[::16, ::16] = 129
    img[16:32, 16:32] = np.random.default_rng(7).integers(0, 256, (16, 16))
    return img, encoder.encode_frame_htj2k(img, nreslevels=1,
                                           log2_cblk_width=4,
                                           log2_cblk_height=4)


def test_long_tail_codeblock_is_an_oracle_span_and_counted(tracer):
    img, stream = _long_tail_stream()
    dec = Decoder(device="cpu")
    before = trace.counters.get("oracle_lanes", 0)
    frame = dec.decode(stream)
    assert np.array_equal(frame.planes[0], img) and dec.v3_frames == 1
    assert trace.counters["oracle_lanes"] - before == 1
    spans = tracer.drain()
    (oracle,) = [s for s in spans if s[0] == "oracle"]
    assert spans[oracle[4]][0] == "lane_cols"


@pytest.mark.parametrize("entry", ENTRIES)
def test_direct_prep_counts_the_v3_lanes_and_no_v2_lane(frames, tracer,
                                                       entry):
    """A traced v3 decode counts ``direct_prep_lanes`` = N lanes a frame
    (the lane build's direct pass from the bodies); a v2 decode, whose
    refinement lanes take the byte-matrix prep, counts none."""
    imgs, streams = frames
    hdr = parse_codestream(streams[0], bitexact=True)
    n = FP.FlatGeometry(hdr).ncblks
    dec = Decoder(device="cpu")
    before = trace.counters.get("direct_prep_lanes", 0)
    got = _decode(dec, entry, streams)
    assert [f.planes[0].tolist() for f in got] == [x.tolist() for x in imgs]
    assert dec.v3_frames == len(streams) and not dec.v2_frames
    assert trace.counters["direct_prep_lanes"] - before == n * len(streams)
    assert any(s[0] == "lane_args" for s in tracer.drain())
    v2 = encoder.encode_frame_htj2k(imgs[0], refinement=True, ht_layers=2,
                                    **ENC)
    before = trace.counters["direct_prep_lanes"]
    frame = dec.decode(v2)
    assert dec.v2_frames == 1 and np.array_equal(frame.planes[0], imgs[0])
    assert trace.counters["direct_prep_lanes"] == before


def test_builds_count_a_new_geometry_once(frames, tracer):
    _imgs, streams = frames
    dec = Decoder(device="cpu")
    b0 = trace.counters.get("builds", 0)
    dec.decode(streams[0])
    first = trace.counters["builds"] - b0
    # the geometry, its assembly plan and the F = 1 program
    assert first == 3
    assert sum(s[0] == "build" for s in tracer.drain()) == first
    dec.decode(streams[1])
    assert trace.counters["builds"] - b0 == first
    assert not any(s[0] == "build" for s in tracer.drain())


# ---- the benchmark's readers of the program's record

MS = 1_000_000          # ns


class FakeTracer:
    """The tracer's interface over a synthetic record: two frames of a
    stream, call 1 dispatched over 0-10 ms and finished over 30-40 ms,
    call 2 over 10-20 ms and 40-50 ms."""

    def __init__(self, dispatch=True):
        self.counters = {"builds": 5, "oracle_lanes": 2}
        self._launches, self._on, self._recorded = 100, False, False
        self.spans = []
        for call, d0, f0 in ((1, 0, 30), (2, 10, 40)):
            base = len(self.spans)
            self.spans += [
                ("dispatch" if dispatch else "other", d0, d0 + 10, call, -1),
                ("parse", d0 + 1, d0 + 2, call, base),
                ("lane_cols", d0 + 2, d0 + 6, call, base),
                ("oracle", d0 + 3, d0 + 4, call, base + 2),
                ("lane_args", d0 + 6, d0 + 7, call, base),
                ("upload", d0 + 7, d0 + 8, call, base),
                ("launch", d0 + 8, d0 + 9, call, base),
                ("finish", f0, f0 + 10, call, -1),
                ("fetch", f0, f0 + 1, call, base + 7),
                ("write", f0 + 1, f0 + 9, call, base + 7)]
        self.spans = [(n, (1000 + s) * MS, (1000 + e) * MS, c, p)
                      for n, s, e, c, p in self.spans]

    def record(self):
        """The window: its spans, and what it adds to the counters."""
        self._recorded = True
        self.counters = {"builds": 6, "oracle_lanes": 5}
        self._launches += 20

    def drain(self):
        if not self._recorded:
            return []
        out, self.spans = self.spans, []
        return out

    def enable(self):
        self._on = True

    def disable(self):
        self._on = False

    def launches(self):
        return self._launches


READERS = {"parse_ms": 1.0, "lane_cols_ms": 4.0, "lane_args_ms": 1.0,
           "upload_ms": 1.0, "launch_ms": 1.0, "fetch_ms": 1.0,
           "write_ms": 8.0, "output_held_ms": 20.0,
           "launches_per_frame": 10.0, "oracle_lanes_per_frame": 1.5,
           "builds": 1}


def _traced(monkeypatch, fake):
    monkeypatch.setattr(program_trace, "_tracer", lambda: fake)
    for name in READERS:
        # what the harness asks each reader for as the window opens
        assert getattr(spec.module("layers", name), "SPANS") == ()
    if fake is not None:
        fake.record()
    return tracing.TraceData(t0=1.0, t1=1.05, frames=2,
                             spans=[("host_write", 1.0305, 1.0395)])


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_on_a_synthetic_window(monkeypatch, name):
    t = _traced(monkeypatch, FakeTracer())
    assert spec.module("layers", name).read(t) == pytest.approx(
        READERS[name])


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_is_none_without_the_programs_tracer(monkeypatch, name):
    t = _traced(monkeypatch, None)
    assert spec.module("layers", name).read(t) is None
    # a tracer that saw no entry call (the control's window): None too
    t = _traced(monkeypatch, FakeTracer(dispatch=False))
    assert spec.module("layers", name).read(t) is None


def test_reader_module_answers_only_spans():
    with pytest.raises(AttributeError):
        getattr(spec.module("layers", "parse_ms"), "OTHER")


def test_idle_gaps_take_the_innermost_span_of_either_kind(monkeypatch):
    t = _traced(monkeypatch, FakeTracer())
    assert program_trace.window(t) is not None
    gaps = dict(t.idle_by_host_span(n=20))
    # the program's spans are labelled by their own names; the write of
    # call 1 lies inside the wrapped host_write span, and is innermost
    assert gaps["write"] == pytest.approx(0.016)
    assert gaps["lane_cols"] == pytest.approx(0.006)
    assert gaps["oracle"] == pytest.approx(0.002)
    assert gaps["host_write"] == pytest.approx(0.001)
    assert gaps["loop"] == pytest.approx(0.010)
    assert sum(gaps.values()) == pytest.approx(t.window_s)


def test_clock_drift_us_is_the_change_of_the_offset(monkeypatch, capsys):
    offset = [1_000]          # wall clock minus perf_counter, ns
    monkeypatch.setattr(program_trace, "_offset_ns", lambda: offset[0])
    t = _traced(monkeypatch, FakeTracer())
    offset[0] = 3_500
    w = program_trace.window(t)
    assert w.clock_drift_us == pytest.approx(2.5)
    assert "clock_drift_us 2.5 " in capsys.readouterr().err
