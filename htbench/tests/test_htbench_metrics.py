"""The metric arithmetic: rates over the whole window, the percentile
over every frame, compulsory bytes and the roofline, busy and idle time,
and a wrapped program name that is gone."""

import numpy as np
import pytest

from htbench import spec, tracing, window


def _e2e(name):
    return spec.module("end_to_end", name).read


def _layer(name):
    return spec.module("layers", name).read


def test_fps_counts_every_frame_over_the_whole_window():
    rec = window.WindowRecord(t0=10.0, setup_s=4.5)
    rec.t_in = [10.0, 10.0, 12.0, 12.0]
    rec.t_out = [12.0, 12.0, 15.0, 15.0]
    rec.t_end = 15.0
    assert _e2e("fps")(rec) == pytest.approx(4 / 5.0)
    assert _e2e("setup_s")(rec) == 4.5


def test_p90_is_over_every_frame():
    rec = window.WindowRecord(t0=0.0)
    lat = np.arange(1, 101) / 1000.0          # 1 .. 100 ms
    rec.t_in = list(np.arange(100.0))
    rec.t_out = list(np.arange(100.0) + lat)
    rec.t_end = rec.t_out[-1]
    assert _e2e("frame_ms_p90")(rec) == pytest.approx(
        float(np.percentile(np.arange(1, 101), 90)))


def test_a_window_with_no_frame_reports_nothing():
    rec = window.WindowRecord(t0=1.0, t_end=1.0)
    assert _e2e("fps")(rec) is None
    assert _e2e("frame_ms_p90")(rec) is None


def _trace(**kw):
    base = dict(t0=0.0, t1=10.0, frames=4, hbm_bytes_per_s=3.35e12,
                stream_bytes=4 * 10_000_000,
                output_bytes=4 * 4096 * 2160 * 3 * 2)
    base.update(kw)
    return tracing.TraceData(**base)


def test_program_busy_leaves_out_host_copies_and_overlaps():
    ops = [("ht_vlc_pass", 1.0, 1.004), ("ht_magsgn_pass", 1.002, 1.006),
           ("Memcpy HtoD (Pinned -> Device)", 0.5, 0.9),
           ("Memcpy DtoH (Device -> Pinned)", 2.0, 3.0)]
    t = _trace(device_ops=ops)
    assert _layer("program_busy_ms")(t) == pytest.approx(6.0 / 4)
    assert t.busy_s() == pytest.approx(0.006 + 0.4 + 1.0)
    assert _layer("device_idle_pct")(t) == pytest.approx(
        100 * (1 - 1.406 / 10))


def test_roofline_is_compulsory_bytes_over_bandwidth_and_busy_time():
    t = _trace(device_ops=[("k", 1.0, 1.004)])
    want = (4 * 10_000_000 + 4 * 4096 * 2160 * 3 * 2) / 3.35e12 / 0.004
    assert _layer("kernels_roofline")(t) == pytest.approx(100 * want)
    assert _layer("kernels_roofline")(_trace()) is None
    assert _layer("kernels_roofline")(
        _trace(device_ops=[("k", 1.0, 1.004)], hbm_bytes_per_s=None)) is None


def test_span_ms_per_frame_and_idle_split_by_host_span():
    spans = [("host_parse", 0.0, 1.0), ("host_lane", 1.0, 4.0),
             ("host_write", 5.0, 6.0)]
    t = _trace(spans=spans, device_ops=[("k", 4.0, 5.0)])
    assert _layer("host_lane_ms")(t) == pytest.approx(3000 / 4)
    assert _layer("host_write_ms")(t) == pytest.approx(1000 / 4)
    idle = dict(t.idle_by_host_span())
    assert idle == pytest.approx({"host_parse": 1.0, "host_lane": 3.0,
                                  "host_write": 1.0, "loop": 4.0})
    assert t.top_device_ops() == [["k", 1.0]]


def test_a_wrapped_name_that_is_gone_gives_null_not_a_crash():
    s = tracing.Spans({"host_parse": {"wrap": [
        "ffmpeg_ht_tpu_torch.models.decoder:parse_codestream",
        "ffmpeg_ht_tpu_torch.models.decoder:no_such_function"]},
        "host_write": {"wrap": ["no_such_module:f"]}})
    try:
        assert s.absent == {"host_parse", "host_write"}
        t = _trace(spans=s.records, absent=s.absent)
        assert _layer("host_parse_ms")(t) is None
        assert _layer("host_write_ms")(t) is None
    finally:
        s.remove()


def test_spans_wrap_the_program_and_put_it_back():
    from ffmpeg_ht_tpu_torch.models import assembly, decoder, fastpath
    before = (decoder.parse_codestream, fastpath.build_v3_frame,
              vars(decoder.Decoder)["_split_frames"],
              vars(assembly.V3Program)["__call__"])
    s = tracing.Spans()
    assert not s.absent
    assert decoder.parse_codestream is not before[0]
    s.remove()
    after = (decoder.parse_codestream, fastpath.build_v3_frame,
             vars(decoder.Decoder)["_split_frames"],
             vars(assembly.V3Program)["__call__"])
    assert after == before


def test_a_cell_installs_only_the_spans_its_readers_name():
    from htbench import run, spec
    cell = spec.load_cell("c1-batch16-natural")
    labels = run.span_labels(cell)
    assert labels == {"host_parse", "host_lane", "host_write",
                      "program_call", "fetch_wait"}
    assert set(spec.span_specs(["host_lane"])) == {"host_lane"}
    # a label whose file is not there is absent, and reads None
    s = tracing.Spans(spec.span_specs(["host_lane", "no_such_span"]))
    try:
        assert s.absent == {"no_such_span"}
    finally:
        s.remove()
