"""The float 9/7 levels of ``dwt_lift`` and ``ict_writeframe``: their
share of their roofline, %.

The least time the card could take for them is the bytes they have to
move (``float97_bytes.frame_bytes``: each level's bands read and output
written once, the ICT's float32 samples read and 8-bit samples written
once) over its memory bandwidth. The share is that time over their
kernels' summed time in the device trace (``lift_tiles`` of the float
9/7 and ``ict_kernel`` of the float ICT), so it cannot pass 100%. None
where the cell's frames are of no float 9/7 configuration or the trace
holds neither kernel.
"""

from .. import float97_bytes

# the kernels of the float route: every substring of one entry in a name
KERNELS = (("lift_tiles", "Lift97f"), ("ict_kernel", "IctFloat"))


def kernel_s(t) -> float:
    """Seconds of the window in the float route's kernels, summed."""
    total = 0.0
    for name, s, e in t.device_ops:
        if any(all(k in name for k in ks) for ks in KERNELS):
            total += max(0.0, min(e, t.t1) - max(s, t.t0))
    return total


def read(t):
    if not t.hbm_bytes_per_s or t.frames == 0:
        return None
    config = float97_bytes.float97_config(t.output_bytes // t.frames)
    busy = kernel_s(t)
    if config is None or busy <= 0:
        return None
    bound_s = (float97_bytes.frame_bytes(config) * t.frames
               / t.hbm_bytes_per_s)
    return 100.0 * bound_s / busy
