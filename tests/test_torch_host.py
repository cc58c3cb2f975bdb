"""The port's own host tier vs the JAX package's.

``ffmpeg_ht_tpu_torch`` carries a copy of every framework-free module it
uses (codestream parse and T2, the native tier, stream prep, lane
building, the host oracle, the encoder). The copies must give the same
bytes and arrays as the originals on the same inputs, and nothing in the
port, nor ``chip_smoke.py`` or the port's tools, may import
``jax`` or the JAX package at any level. Small streams only: 96x128,
``nreslevels=3``, 32x32 codeblocks.
"""

import ast
import os

import numpy as np
import pytest

from ffmpeg_ht_tpu.codestream.parser import parse_codestream as jax_parse
from ffmpeg_ht_tpu.models import encoder as jax_enc
from ffmpeg_ht_tpu.models import fastpath as jax_fp
from ffmpeg_ht_tpu.models import host_decoder as jax_host
from ffmpeg_ht_tpu_torch.codestream.parser import parse_codestream
from ffmpeg_ht_tpu_torch.models import encoder as port_enc
from ffmpeg_ht_tpu_torch.models import fastpath as port_fp
from ffmpeg_ht_tpu_torch.models import host_decoder as port_host
from ffmpeg_ht_tpu_torch.utils import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENC = dict(nreslevels=3, log2_cblk_width=5, log2_cblk_height=5)
RNG = np.random.default_rng(20261017)
GRAY8 = RNG.integers(0, 256, (96, 128), dtype=np.uint8)
RGB10 = RNG.integers(0, 1024, (96, 128, 3), dtype=np.uint16)
LEGACY = RNG.integers(0, 256, (32, 48), dtype=np.uint8)
# name -> (encoder function name, image, options)
STREAMS = {
    "gray8": ("encode_frame_htj2k", GRAY8, ENC),
    "rgb10_rct": ("encode_frame_htj2k", RGB10, dict(ENC, depth=10, mct=True)),
    "legacy_mq": ("encode_frame_t800", LEGACY, dict(pred=1)),
}


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tools", "sweep_vlc_pass.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO,
                                                   "ffmpeg_ht_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported(tree):
    """Every module name an import statement in `tree` names."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 30
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for name in _imported(tree):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "ffmpeg_ht_tpu"):
                bad.append(f"{os.path.relpath(path, REPO)}: {name}")
    assert not bad, bad


@pytest.mark.parametrize("name", list(STREAMS))
def test_encoder_bytes_match_jax(name):
    fn, img, opts = STREAMS[name]
    want = getattr(jax_enc, fn)(img, **opts)
    got = getattr(port_enc, fn)(img, **opts)
    assert isinstance(got, bytes) and got == want


@pytest.mark.parametrize("name", ["gray8", "rgb10_rct"])
def test_v3_lane_arrays_match_jax(name):
    """parse -> FlatGeometry -> native T2 -> build_v3_frame, each package
    on its own copy, then the port's finish_v3_numpy against the JAX
    finish_v3: equal arrays."""
    fn, img, opts = STREAMS[name]
    data = getattr(jax_enc, fn)(img, **opts)
    jhdr = jax_parse(data, bitexact=True)
    jfg = jax_fp.FlatGeometry(jhdr)
    jfc = jax_fp.build_v3_frame(jfg, jax_fp.parse_frame_flat(jhdr, jfg))
    hdr = parse_codestream(data, bitexact=True)
    fg = port_fp.FlatGeometry(hdr)
    fc = port_fp.build_v3_frame(fg, port_fp.parse_frame_flat(hdr, fg))
    assert fg.geom.key() == jfg.geom.key()
    assert port_fp.geometry_fingerprint(hdr) == \
        jax_fp.geometry_fingerprint(jhdr)
    for k in ("data", "lcups", "pcups", "qws", "qhs", "pLSB", "maxbp"):
        assert np.array_equal(fc[k], jfc[k]), k
    assert len(fc["host_pf"]) == len(jfc["host_pf"])
    want, _ = jax_fp.finish_v3(jfg, [jfc], jfg.geom.total)
    got, _ = port_fp.finish_v3_numpy(fg, [fc], fg.geom.total)
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k


def test_host_oracle_matches_jax_on_legacy_stream():
    fn, img, opts = STREAMS["legacy_mq"]
    data = getattr(port_enc, fn)(img, **opts)
    got = port_host.decode_frame(data, bitexact=True)
    want = jax_host.decode_frame(data, bitexact=True)
    assert got.fmt.name == want.fmt.name
    assert got.tobytes() == want.tobytes() == img.tobytes()


def test_native_tier_builds_and_loads():
    lib = native.load()
    assert lib is not None and native.load() is lib
    assert os.path.exists(native.LIB_PATH)
    assert os.path.dirname(native.LIB_PATH).endswith(
        os.path.join("build", "ffmpeg_ht_tpu_torch"))
    msw, melw, vlcw, ms_lim, mel_lim = native.ht_prepare_streams(
        np.zeros((2, 8), np.uint8), np.full(2, 2), np.zeros(2, np.int64),
        want_limits=True)
    assert msw.dtype == np.uint32 and ms_lim.shape == (2,)
