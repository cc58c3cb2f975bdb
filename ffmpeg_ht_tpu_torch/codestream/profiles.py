"""Rsiz -> profile names (profiles.c:107-115 / defs.h:148-152 analog)."""

from __future__ import annotations


def profile_name(rsiz: int) -> str:
    """Human-readable codestream profile from the SIZ Rsiz field."""
    base = rsiz & 0x3FFF
    names = {
        0: "JPEG 2000 codestream, no restriction",
        1: "JPEG 2000 codestream restriction 0",
        2: "JPEG 2000 codestream restriction 1",
        3: "JPEG 2000 digital cinema 2K",
        4: "JPEG 2000 digital cinema 4K",
    }
    tag = names.get(base, f"JPEG 2000 profile {base}")
    if rsiz & 0x4000:
        tag += " + High-Throughput (Part 15)"
    return tag
