"""A cell small enough for a CPU test: a real cell of BENCHMARK.json with
its configuration cut to 64x64 and its cycle to K = 4 frames."""

from __future__ import annotations

import dataclasses

from htbench import spec


def tiny_cell(like: str, per_call: int = None) -> spec.Cell:
    cell = spec.load_cell(like)
    config = dict(cell.config, height=64, width=64)
    traffic = dict(cell.traffic, distinct=4)
    if per_call is not None:
        traffic["frames_per_call"] = per_call
    return dataclasses.replace(cell, name=f"tiny-{like}", config=config,
                               traffic=traffic)
