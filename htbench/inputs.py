"""A cell's inputs: K seeded sources, and their streams from the frozen
encoder.

Frame i of a run with seed s is made by ``content/<kind>.py`` from
``numpy.random.default_rng([s mod 2**64, i])``, so the same seed gives
the same frames. Sources are made and encoded in spawned worker
processes, one frame a task. The streams of a (cell, seed) are cached in
one file under ``build/htbench/streams/<cell>/``; each cell keeps its
``CACHE_KEEP`` most recently used files, so the cache stays bounded.
"""

from __future__ import annotations

import hashlib
import json
import multiprocessing
import os
from typing import List

import numpy as np

from . import spec

CACHE_DIR = os.path.join(spec.ROOT, "build", "htbench", "streams")
CACHE_KEEP = 8


def frame_rng(seed: int, index: int):
    return np.random.default_rng([seed % (1 << 64), index])


def make_source(config: dict, traffic: dict, seed: int, index: int):
    """Source frame `index` of the cell's cycle, as the content kind
    makes it from the seed."""
    kind = spec.module("content", traffic["content"])
    return kind.make(frame_rng(seed, index), config["height"],
                     config["width"], config["components"], config["depth"],
                     **traffic.get("params", {}))


def _source_job(job):
    return make_source(*job)


def _stream_job(job):
    from .frozen.models.encoder import encode_frame_htj2k
    config = job[0]
    return encode_frame_htj2k(make_source(*job), **config["encoder"])


class _Pending:
    """fn over jobs in spawned worker processes, started at once; ``get``
    waits for the results (handed to `then`, if given), ``close`` ends
    every worker, done or not."""

    def __init__(self, fn, jobs, workers: int, then=None):
        ctx = multiprocessing.get_context("spawn")
        self._pool = ctx.Pool(workers)
        self._res = self._pool.map_async(fn, jobs, chunksize=1)
        self._then = then

    def get(self):
        try:
            out = self._res.get()
            self._pool.close()
        finally:
            self.close()
        return self._then(out) if self._then else out

    def close(self) -> None:
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None


class _Done:
    def __init__(self, value):
        self._value = value

    def get(self):
        return self._value

    def close(self) -> None:
        pass


def _pool_map(fn, jobs, workers: int):
    if workers <= 1:
        return [fn(j) for j in jobs]
    return _Pending(fn, jobs, workers).get()


def workers_for(n: int) -> int:
    return max(1, min(n, os.cpu_count() or 1))


def sources(config: dict, traffic: dict, seed: int) -> List[np.ndarray]:
    """The K distinct source frames of the cell's cycle."""
    jobs = [(config, traffic, seed, i) for i in range(traffic["distinct"])]
    return _pool_map(_source_job, jobs, workers_for(len(jobs)))


def _cache_path(cell: str, config: dict, traffic: dict, seed: int) -> str:
    key = hashlib.sha256(json.dumps([config, traffic],
                                    sort_keys=True).encode()).hexdigest()
    return os.path.join(CACHE_DIR, cell, f"{seed}-{key[:16]}.bin")


def _read(path: str) -> List[bytes]:
    with open(path, "rb") as f:
        data = f.read()
    n = int(np.frombuffer(data[:8], np.int64)[0])
    lens = np.frombuffer(data[8:8 + 8 * n], np.int64)
    out, off = [], 8 + 8 * n
    for ln in lens:
        out.append(data[off:off + int(ln)])
        off += int(ln)
    if off != len(data):
        raise ValueError(f"{path}: {len(data)} bytes, index says {off}")
    return out


def _write(path: str, streams: List[bytes]) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(np.array([len(streams)], np.int64).tobytes())
        f.write(np.array([len(s) for s in streams], np.int64).tobytes())
        for s in streams:
            f.write(s)
    os.replace(tmp, path)
    kept = sorted((os.path.getmtime(os.path.join(d, f)), os.path.join(d, f))
                  for d in [os.path.dirname(path)]
                  for f in os.listdir(d) if f.endswith(".bin"))
    for _, old in kept[:-CACHE_KEEP]:
        os.remove(old)


def start_streams(cell: str, config: dict, traffic: dict, seed: int,
                  cache: bool = True):
    """Start making the K streams of the cell's cycle for `seed`: read
    from the cache, or made and encoded in worker processes while the
    caller goes on (and then cached). Returns an object whose ``get``
    gives the list, and whose ``close`` ends the workers."""
    path = _cache_path(cell, config, traffic, seed)
    if cache and os.path.exists(path):
        os.utime(path)
        return _Done(_read(path))
    from .frozen.utils import native
    native.load()           # built once here, not raced by the workers
    jobs = [(config, traffic, seed, i) for i in range(traffic["distinct"])]

    def store(out):
        if cache:
            _write(path, out)
        return out
    return _Pending(_stream_job, jobs, workers_for(len(jobs)), then=store)


def streams(cell: str, config: dict, traffic: dict, seed: int,
            cache: bool = True) -> List[bytes]:
    """The K streams of the cell's cycle for `seed` (``start_streams``,
    waited for)."""
    return start_streams(cell, config, traffic, seed, cache).get()
