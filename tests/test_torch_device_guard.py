"""Every kernel wrapper launches under its tensors' device.

The ``csrc/*.cu`` entry points launch on the CUDA runtime's current
device with the stream they are given; a wrapper passes the current
stream of its tensors' device. So each launch must sit inside
``torch.cuda.device(<that device>)``, or a tensor on a second card meets
a stream of another device. Showing that by running it needs two cards;
here the source is checked instead: every ``*_launch`` call of the
wrappers is inside a ``with torch.cuda.device(X)`` whose X is the device
whose current stream the call passes, and every entry point of the kernel
library has such a call. Also pinned: the wrappers' own device check still
raises before anything is launched (a fake library records launches).
"""

import ast
import inspect

import pytest
import torch

from ffmpeg_ht_tpu_torch.ops import (coef_cuda, dwt_cuda, ht_refine, ht_scan,
                                     mct_cuda, wirepack)
from ffmpeg_ht_tpu_torch.utils import build

WRAPPERS = {
    "ht_vlc_pass": ht_scan.ht_vlc_pass,
    "ht_magsgn_pass": ht_scan.ht_magsgn_pass,
    "ht_sigprop_pass": ht_refine.ht_sigprop_pass,
    "ht_magref_pass": ht_refine.ht_magref_pass,
    "rct_writeframe": mct_cuda.rct_writeframe,
    "ict_writeframe": mct_cuda.ict_writeframe,
    "wire_pack": wirepack.pack_words,
    "coef_mosaic": coef_cuda.coef_mosaic,
    # dwt_lift and dwt_lift_program launch through dwt_cuda._launch
    "dwt_lift": dwt_cuda._launch,
    "dwt_lift_program": dwt_cuda._launch,
    # dwt_lift_program's small levels through dwt_small
    "dwt_small": dwt_cuda.dwt_small,
    "bucket_scatter": coef_cuda.bucket_scatter,
    "plane_writeframe": mct_cuda.plane_writeframe,
}


def _is_attr_call(node, dotted):
    """node is a call of the dotted name `dotted` (``torch.cuda.device``)."""
    if not isinstance(node, ast.Call):
        return False
    return ast.unparse(node.func) == dotted


def _launches(fn):
    """[(the entry point's name, the device expression of its stream,
    the device expressions of the ``with torch.cuda.device`` blocks that
    hold the call)] for every ``build.load().lib.*_launch`` call in fn."""
    tree = ast.parse(inspect.getsource(fn).lstrip())
    found = []

    def walk(node, guards):
        if isinstance(node, ast.With):
            guards = guards + [ast.unparse(item.context_expr.args[0])
                               for item in node.items
                               if _is_attr_call(item.context_expr,
                                                "torch.cuda.device")]
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute) \
                and node.func.attr.endswith("_launch"):
            streams = [ast.unparse(a.value.args[0]) for a in node.args
                       if isinstance(a, ast.Attribute)
                       and a.attr == "cuda_stream"
                       and _is_attr_call(a.value,
                                         "torch.cuda.current_stream")]
            found.append((node.func.attr, streams, guards))
        for child in ast.iter_child_nodes(node):
            walk(child, guards)

    walk(tree, [])
    return found


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_launch_sits_inside_its_device(name):
    launches = _launches(WRAPPERS[name])
    assert launches, f"{name}: no kernel launch found"
    for entry, streams, guards in launches:
        assert len(streams) == 1, f"{entry}: stream argument not found"
        assert streams[0] in guards, (
            f"{entry} passes the stream of {streams[0]} outside "
            f"torch.cuda.device({streams[0]}) (guards: {guards})")


def test_every_entry_point_is_guarded():
    """Each C entry point of the kernel library is launched by one of the
    wrappers above, so a new kernel's wrapper joins this check."""
    launched = {entry for fn in WRAPPERS.values()
                for entry, _s, _g in _launches(fn)}
    assert launched == set(build._SIGNATURES)


class _FakeLib:
    """A kernel library that records every entry point called."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *a: self.calls.append(name) or 0


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_device_check_still_raises(name, monkeypatch):
    """A tensor on a device that is neither the CPU nor a card is refused
    by the wrapper's existing check; nothing reaches the library."""
    lib = _FakeLib()
    monkeypatch.setattr(build, "load", lambda: type("K", (), {"lib": lib}))
    meta = lambda *shape, dtype=torch.int32: torch.empty(
        shape, dtype=dtype, device="meta")
    i32 = meta(4, 8)
    v = meta(4)
    b = meta(4, dtype=torch.bool)
    calls = {
        "ht_vlc_pass": lambda: ht_scan.ht_vlc_pass(i32, i32, v, v, v, 2, 2),
        "ht_magsgn_pass": lambda: ht_scan.ht_magsgn_pass(
            meta(4, 2, 2), i32, v, v, v, v, v, 2, 2, 8),
        "ht_sigprop_pass": lambda: ht_refine.ht_sigprop_pass(
            meta(4, 2, 2), i32, b, b, 2, 2, 4, 4),
        "ht_magref_pass": lambda: ht_refine.ht_magref_pass(
            meta(4, 4, 4), meta(4, 2, 2), i32, v, b, i32, 2, 2, 4, 4),
        "rct_writeframe": lambda: mct_cuda.rct_writeframe(
            meta(4, 4), meta(4, 4), meta(4, 4), 10),
        "ict_writeframe": lambda: mct_cuda.ict_writeframe(
            [(meta(4, 4), meta(4, 4), meta(4, 4))], 8, mct_cuda.DWT97_INT),
        "wire_pack": lambda: wirepack.pack_words(meta(33, dtype=torch.int16),
                                                 10),
        "coef_mosaic": lambda: coef_cuda.coef_mosaic(
            meta(4, 2, 2), v, v, v, meta(4, dtype=torch.float32), v, v,
            coef_cuda.CoefLayout([], 4, 2, 2), mct_cuda.DWT97_INT, False),
        "dwt_lift": lambda: dwt_cuda.dwt_lift(
            [(meta(4, 4), meta(4, 4), meta(4, 4), meta(4, 4), 0, 0, False)],
            mct_cuda.DWT97_INT),
        "dwt_lift_program": lambda: dwt_cuda.dwt_lift_program(
            dwt_cuda.LiftPlan([0, 16, 32, 48], [(4, 4)] * 4,
                              [(0, [(1, 2, 3)], [(0, 0)])],
                              mct_cuda.DWT97_INT), meta(64)),
        "dwt_small": lambda: dwt_cuda.dwt_lift_program(
            dwt_cuda.LiftPlan([0, 4, 8, 12], [(2, 2)] * 4,
                              [(0, [(1, 2, 3)], [(0, 0)])],
                              mct_cuda.DWT97_INT), meta(16)),
        "bucket_scatter": lambda: coef_cuda.bucket_scatter(
            [meta(4, 2, 2)], [(2, 2)],
            [dict(dest=v, stride=v, magb=v, istep=v, scale97=v,
                  fscale=meta(4, dtype=torch.float32))], v, v, 16,
            mct_cuda.DWT97_INT, False),
        "plane_writeframe": lambda: mct_cuda.plane_writeframe(
            [meta(4, 4)], 10, meta(16, dtype=torch.int16),
            mct_cuda.back_to_back((4, 4), 1)),
    }
    with pytest.raises(ValueError, match="device"):
        calls[name]()
    assert lib.calls == []
