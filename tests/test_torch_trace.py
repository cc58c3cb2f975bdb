"""The port's spans and counters (``ffmpeg_ht_tpu_torch/utils/trace.py``)
on the CPU, and the benchmark's readers of them (``htbench/layers``,
``htbench/program_trace.py``) on synthetic windows.

Off, the tracer records nothing; on, each entry call of ``Decoder`` opens
a ``dispatch`` and a ``finish`` span under its own call id, with the
lane build, upload, program call, fetch and write below them. Small
streams only: 96x128 gray (RGB 9/7 + ICT for the float 9/7 count),
``nreslevels=3``, 32x32 codeblocks.
"""

import json

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
    (the v3 lane build's direct pass from the bodies); a v2 decode, whose
    buckets ``pack_bucket`` packs with the same pass, counts none: the
    counter is the v3 lane build's."""
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


def _staged_size(args):
    """Bytes of one staging buffer of `args`: each array at the next
    256-byte aligned offset, in order."""
    pos = 0
    for a in args.values():
        pos = -(-pos // 256) * 256 + a.nbytes
    return pos


@pytest.mark.parametrize("entry", ENTRIES)
def test_staged_frames_count_the_v3_calls_and_no_v2_call(frames, tracer,
                                                         entry):
    """Each v3 program call stages its arguments in one buffer and one
    copy: ``staged_frames`` grows by the frames dispatched and
    ``staged_bytes`` by that buffer's size (the numpy arguments, each at
    a 256-byte aligned offset); a v2 decode counts neither and uploads
    its arrays through ``to_torch`` (its ``upload`` spans)."""
    imgs, streams = frames
    dec = Decoder(device="cpu")
    hdrs = [parse_codestream(d, bitexact=True) for d in streams]
    fg = FP.FlatGeometry(hdrs[0])
    fcs = [FP.build_v3_frame(fg, FP.parse_frame_flat(h, fg)) for h in hdrs]
    calls = [fcs] if entry == "decode_batch" else [[fc] for fc in fcs]
    want = sum(_staged_size(FP.finish_v3_numpy(fg, c, fg.geom.total)[0])
               for c in calls)
    f0 = trace.counters.get("staged_frames", 0)
    b0 = trace.counters.get("staged_bytes", 0)
    tracer.drain()
    got = _decode(dec, entry, streams)
    assert [f.planes[0].tolist() for f in got] == [x.tolist() for x in imgs]
    assert dec.v3_frames == len(streams) and not dec.v2_frames
    assert trace.counters["staged_frames"] - f0 == len(streams)
    assert trace.counters["staged_bytes"] - b0 == want
    assert sum(s[0] == "upload" for s in tracer.drain()) == len(calls)
    v2 = encoder.encode_frame_htj2k(imgs[0], refinement=True, ht_layers=2,
                                    **ENC)
    f0, b0 = trace.counters["staged_frames"], trace.counters["staged_bytes"]
    frame = dec.decode(v2)
    assert dec.v2_frames == 1 and np.array_equal(frame.planes[0], imgs[0])
    assert (trace.counters["staged_frames"],
            trace.counters["staged_bytes"]) == (f0, b0)
    assert sum(s[0] == "upload" for s in tracer.drain()) > 1


@pytest.mark.parametrize("entry", ENTRIES)
def test_host_lane_span_covers_the_staged_upload(frames, tracer, entry):
    """The benchmark's ``host_lane`` span wraps ``decoder.to_torch``, and
    each v3 program call's one staged copy goes through that name: every
    ``upload`` span of the port lies inside a ``host_lane`` record, and
    the span counts a frame's lane columns, each call's stream prep and
    each call's copy."""
    imgs, streams = frames
    dec = Decoder(device="cpu")
    _decode(dec, entry, streams)               # warm: programs built
    calls = 1 if entry == "decode_batch" else len(streams)
    spans = tracing.Spans(spec.span_specs(["host_lane"]))
    try:
        tracer.drain()
        got = _decode(dec, entry, streams)
        ups = [s for s in tracer.drain() if s[0] == "upload"]
    finally:
        spans.remove()
    assert [f.planes[0].tolist() for f in got] == [x.tolist() for x in imgs]
    lane = [(s, e) for lb, s, e in spans.records if lb == "host_lane"]
    assert len(lane) == len(streams) + 2 * calls
    assert len(ups) == calls
    for u in ups:
        assert any(s <= u[1] / 1e9 and u[2] / 1e9 <= e for s, e in lane)


@pytest.mark.parametrize("v3", ["1", "0"])
def test_float97_frames_count_float_frames_on_either_program(monkeypatch,
                                                             v3):
    """Each frame dispatched on the float 9/7 counts once, on the v3 and
    on the v2 program, through both entries; frames of the integer 9/7
    and of the 5/3 count nothing."""
    monkeypatch.setenv("FFMPEG_HT_TPU_V3", v3)
    rgb = np.random.default_rng(4).integers(0, 256, (96, 128, 3),
                                            dtype=np.uint8)
    lossy = [encoder.encode_frame_htj2k(np.roll(rgb, k, 1), pred=0,
                                        mct=True, **ENC) for k in (0, 3)]
    route = "v3_frames" if v3 == "1" else "v2_frames"
    for bitexact, counted in ((False, 1), (True, 0)):
        dec = Decoder(device="cpu", bitexact=bitexact)
        f0 = trace.counters.get("float97_frames", 0)
        dec.decode_batch(lossy)
        list(dec.decode_stream(lossy))
        assert getattr(dec, route) == 4
        assert trace.counters.get("float97_frames", 0) - f0 == 4 * counted
    gray = encoder.encode_frame_htj2k(_gray(9), **ENC)
    f0 = trace.counters.get("float97_frames", 0)
    Decoder(device="cpu").decode_batch([gray, gray])
    assert trace.counters.get("float97_frames", 0) == f0


@pytest.mark.parametrize("v3", ["1", "0"])
def test_device_layout_frames_count_frames_copied_out_of_the_layout(
        monkeypatch, frames, v3):
    """Each frame ``_split_frames`` copies out of the program's frame
    layout counts once, on the v3 and on the v2 program, through both
    entries; the wire-packed route (the identity layout, unpacked and
    written by the host) counts none."""
    monkeypatch.setenv("FFMPEG_HT_TPU_V3", v3)
    _imgs, streams = frames
    dec = Decoder(device="cpu")
    c0 = trace.counters.get("device_layout_frames", 0)
    dec.decode_batch(streams)
    list(dec.decode_stream(streams))
    assert trace.counters["device_layout_frames"] - c0 == 6
    assert dec.v3_frames + dec.v2_frames == 6
    deep = [encoder.encode_frame_htj2k(
        np.random.default_rng(s).integers(0, 4096, (96, 128),
                                          dtype=np.uint16), depth=12, **ENC)
        for s in (5, 6)]
    dec = Decoder(device="cpu", wire_pack=True)
    c0 = trace.counters["device_layout_frames"]
    dec.decode_batch(deep)
    list(dec.decode_stream(deep))
    assert trace.counters["device_layout_frames"] == c0
    assert dec.v3_frames + dec.v2_frames == 4
    fg = dec._fast_geom(parse_codestream(deep[0]))
    assert fg.v3_progs or v3 == "0"
    assert all(p.wire_pack and p.frame_layout.fmt is None
               for p in fg.v3_progs.values())


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
        self.counters = {"builds": 5, "oracle_lanes": 2, "float97_frames": 4,
                         "device_layout_frames": 4, "staged_frames": 4,
                         "staged_bytes": 1000}
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
        self.counters = {"builds": 6, "oracle_lanes": 5, "float97_frames": 6,
                         "device_layout_frames": 6, "staged_frames": 6,
                         "staged_bytes": 3_001_000}
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
           "builds": 1, "float97_frames_per_frame": 1.0,
           "device_layout_frames_per_frame": 1.0,
           "staged_frames_per_frame": 1.0, "upload_mb_per_frame": 1.5}


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


def test_float97_reader_is_none_where_the_program_has_no_counter(
        monkeypatch):
    fake = FakeTracer()
    t = _traced(monkeypatch, fake)
    del fake.counters["float97_frames"]       # an older program's tracer
    assert spec.module("layers", "float97_frames_per_frame").read(t) is None
    assert spec.module("layers", "builds").read(t) == 1


def test_device_layout_reader_is_none_where_the_program_has_no_counter(
        monkeypatch):
    fake = FakeTracer()
    t = _traced(monkeypatch, fake)
    del fake.counters["device_layout_frames"]   # an older program's tracer
    assert spec.module("layers",
                       "device_layout_frames_per_frame").read(t) is None
    assert spec.module("layers", "float97_frames_per_frame").read(t) == 1.0


@pytest.mark.parametrize("counter,name", [
    ("staged_frames", "staged_frames_per_frame"),
    ("staged_bytes", "upload_mb_per_frame")])
def test_staged_readers_are_none_where_the_program_has_no_counter(
        monkeypatch, counter, name):
    fake = FakeTracer()
    t = _traced(monkeypatch, fake)
    del fake.counters[counter]          # a program that stages nothing
    assert spec.module("layers", name).read(t) is None
    assert spec.module("layers", "device_layout_frames_per_frame").read(
        t) == 1.0


def _lossy_window(ops, bw=3.35e12):
    """A 1 s window of eight 1080p RGB frames."""
    return tracing.TraceData(t0=1.0, t1=2.0, frames=8, device_ops=ops,
                             output_bytes=1080 * 1920 * 3 * 8,
                             hbm_bytes_per_s=bw)


def test_dwt97_ict_roofline_on_a_synthetic_trace():
    """The float route's bytes a frame (five levels of 1080p RGB, 8 B a
    sample of each level's output; the ICT 15 B a pixel) over its kernels'
    summed time; the integer and 5/3 kernels and copies are not its."""
    from htbench import float97_bytes
    lift = "void (anonymous namespace)::lift_tiles<(anonymous " \
        "namespace)::Lift97f>(Launch, float const*, float*)"
    ict = "void (anonymous namespace)::ict_kernel<(anonymous " \
        "namespace)::IctFloat, unsigned char>(Args)"
    other = ("void (anonymous namespace)::lift_tiles<(anonymous "
             "namespace)::Lift97i>(Launch, int const*, int*)",
             "Memcpy HtoD (Pinned -> Device)")
    ops = [(lift, 1.1, 1.1002), (lift, 1.2, 1.2001), (ict, 1.3, 1.3001),
           (other[0], 1.4, 1.45), (other[1], 1.5, 1.6),
           (ict, 0.9, 1.0001)]            # 0.1 ms inside the window
    t = _lossy_window(ops)
    config = spec.load_cell("c2-batch8-broadcast").config
    per_frame = 8 * 3 * sum(h * w for h, w in (
        (1080, 1920), (540, 960), (270, 480), (135, 240), (68, 120)))
    assert float97_bytes.dwt97_bytes(config) == per_frame
    assert float97_bytes.ict_bytes(config) == 1080 * 1920 * 15
    want = 100 * (per_frame + 1080 * 1920 * 15) * 8 / 3.35e12 / 5e-4
    read = spec.module("layers", "dwt97_ict_roofline").read
    assert read(t) == pytest.approx(want)
    assert 0 < read(t) < 100


def test_dwt97_ict_roofline_is_none_off_the_float_route():
    read = spec.module("layers", "dwt97_ict_roofline").read
    t = _lossy_window([("Memcpy DtoH (Device -> Pinned)", 1.1, 1.2)])
    assert read(t) is None                     # neither kernel ran
    lift = "lift_tiles<(anonymous namespace)::Lift97f>"
    t = _lossy_window([(lift, 1.1, 1.2)], bw=None)
    assert read(t) is None                     # no peak for this card
    t = tracing.TraceData(t0=1.0, t1=2.0, frames=4, device_ops=[
        (lift, 1.1, 1.2)], output_bytes=512 * 512 * 4,
        hbm_bytes_per_s=3.35e12)
    assert read(t) is None                     # a lossless gray frame


def test_dwt97_ict_roofline_raises_where_two_configurations_match(
        tmp_path, monkeypatch):
    """Two float 9/7 configurations of one frame size cannot be told
    apart from the trace data: the reader fails loudly, not None."""
    from htbench import float97_bytes
    with open(spec.BENCHMARK) as f:
        bench = json.load(f)
    c2 = next(c for c in bench["configs"] if c["name"] == "hd1080-rgb8-ict97")
    bench["configs"].append(dict(c2, name="hd1080-twin"))
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    monkeypatch.setattr(spec, "BENCHMARK", str(path))
    lift = "lift_tiles<(anonymous namespace)::Lift97f>"
    with pytest.raises(ValueError, match="hd1080-twin"):
        spec.module("layers", "dwt97_ict_roofline").read(
            _lossy_window([(lift, 1.1, 1.2)]))


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
