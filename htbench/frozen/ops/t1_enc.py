"""The code-block records that the packet writer reads.

``Pass`` and ``EncCblk`` of the port's ``ops/t1_enc.py`` (the T.800
tier-1 encoder there; ffmpeg's libavcodec/j2kenc.c:616-767), unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class Pass:
    rate: int = 0
    disto: int = 0
    flushed: bytes = b""


@dataclass
class EncCblk:
    """Per-codeblock encode result consumed by rate control and T2."""
    nonzerobits: int = 0
    npasses: int = 0
    ninclpasses: int = 0
    data: bytes = b""
    passes: List[Pass] = field(default_factory=list)
    # T2 state
    incl: bool = False
    lblock: int = 3
    layers: List[dict] = field(default_factory=list)
