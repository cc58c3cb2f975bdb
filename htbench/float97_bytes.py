"""The bytes that the float 9/7 levels of ``dwt_lift`` and
``ict_writeframe`` have to move for one frame, counted from the
configuration. The count is of the work, so it reads the same whatever
implements the kernels:

- a DWT level whose output is an (h, w) plane reads its four bands, h x w
  float32 samples in all, and writes its output once: 8 h w bytes, for
  each level of each component;
- the ICT reads the three components' float32 samples of a pixel and
  writes its three output samples once: 3 x 4 + 3 x 1 bytes a pixel at 8
  bits (3 x 2 written past 8 bits).

Nothing here imports the program or torch.
"""

from __future__ import annotations

import json
from typing import List, Optional, Tuple

from . import spec


def level_sizes(height: int, width: int, levels: int) -> List[Tuple[int,
                                                                   int]]:
    """(h, w) of each DWT level's output, the full frame first, for a
    frame at the origin."""
    return [(-(-height >> k), -(-width >> k)) for k in range(levels)]


def sample_bytes(depth: int) -> int:
    """Bytes of an output sample in the decoder's pixel format."""
    return 1 if depth <= 8 else 2


def output_bytes(config: dict) -> int:
    """Bytes of one decoded frame, as the harness counts them."""
    return (config["height"] * config["width"] * config["components"]
            * sample_bytes(config["depth"]))


def dwt97_bytes(config: dict) -> int:
    levels = config["encoder"]["nreslevels"] - 1
    return sum(8 * h * w for h, w in level_sizes(
        config["height"], config["width"], levels)) * config["components"]


def ict_bytes(config: dict) -> int:
    return (config["height"] * config["width"]
            * 3 * (4 + sample_bytes(config["depth"])))


def frame_bytes(config: dict) -> int:
    """The float 9/7 levels' and the ICT's bytes of one frame."""
    return dwt97_bytes(config) + ict_bytes(config)


def float97_config(frame_output_bytes: int) -> Optional[dict]:
    """The configuration of ``BENCHMARK.json`` decoded with the float 9/7
    (decoder ``bitexact`` false) whose frames have `frame_output_bytes`
    bytes; None where none has. The harness's trace data does not name
    the cell's configuration, so the frame size stands in for it: where
    two such configurations share a frame size this cannot tell them
    apart, and raises ValueError."""
    with open(spec.BENCHMARK) as f:
        bench = json.load(f)
    found = []
    for c in bench["configs"]:
        config = spec.load_config(c["file"])
        if config["decoder"].get("bitexact", True) is False \
                and output_bytes(config) == frame_output_bytes:
            found.append((c["name"], config))
    if len(found) > 1:
        raise ValueError(f"float 9/7 configurations {[n for n, _ in found]} "
                         f"share a frame of {frame_output_bytes} bytes")
    return found[0][1] if found else None
