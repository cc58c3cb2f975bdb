"""The seeded sources: the same seed gives the same frames, another seed
or frame index others, at every depth and component count."""

import numpy as np
import pytest

from htbench import inputs, spec

BIG = 2 ** 31 + 12345


def _cfg(components, depth):
    return {"height": 40, "width": 72, "components": components,
            "depth": depth}


@pytest.mark.parametrize("traffic", ["stream-natural-k4",
                                     "batch4-grain-k4"])
@pytest.mark.parametrize("components,depth", [(1, 8), (3, 10)])
def test_same_seed_same_frames(traffic, components, depth):
    tr = spec.load_traffic(traffic)
    cfg = _cfg(components, depth)
    a = inputs.make_source(cfg, tr, BIG, 3)
    b = inputs.make_source(cfg, tr, BIG, 3)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, inputs.make_source(cfg, tr, BIG + 1, 3))
    assert not np.array_equal(a, inputs.make_source(cfg, tr, BIG, 4))
    shape = (40, 72) if components == 1 else (40, 72, 3)
    assert a.shape == shape
    assert a.dtype == (np.uint8 if depth == 8 else np.uint16)
    assert int(a.max()) < (1 << depth)


def test_grain_adds_noise_of_its_sigma():
    cfg = _cfg(1, 10)
    nat = inputs.make_source(cfg, spec.load_traffic("stream-natural-k4"),
                             7, 0)
    grain = inputs.make_source(cfg, spec.load_traffic("batch4-grain-k4"),
                               7, 0)
    d = grain.astype(np.int64) - nat.astype(np.int64)
    assert 9 < d.std() < 15


def test_sources_are_the_cycle_in_order():
    tr = dict(spec.load_traffic("stream-natural-k4"), distinct=3)
    cfg = _cfg(1, 8)
    got = inputs.sources(cfg, tr, 99)
    assert len(got) == 3
    for i, g in enumerate(got):
        assert np.array_equal(g, inputs.make_source(cfg, tr, 99, i))


def test_stream_cache_round_trip_and_bound(tmp_path, monkeypatch):
    monkeypatch.setattr(inputs, "CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(inputs, "CACHE_KEEP", 2)
    tr = dict(spec.load_traffic("stream-natural-k4"), distinct=2)
    cfg = dict(spec.load_config("htbench/configs/gray512-8b-53.json"),
               height=32, width=32)
    first = inputs.streams("cellx", cfg, tr, 1)
    assert inputs.streams("cellx", cfg, tr, 1) == first
    for seed in (2, 3):
        inputs.streams("cellx", cfg, tr, seed)
    assert len(list((tmp_path / "cellx").iterdir())) == 2
