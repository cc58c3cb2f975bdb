"""The port's CLI (``ffmpeg_ht_tpu_torch/cli.py``) vs the JAX package's.

``cli.main([... "--device", "cpu"])`` decodes through the port's
``Decoder`` on the CPU; its ``decode -f framemd5`` must equal the JAX
CLI's ``decode --host -f framemd5`` (the host oracle, which compiles
nothing) on gray 5/3, RGB 5/3 + RCT and integer 9/7 + ICT streams, each
as a raw J2C, an MJ2 and an MXF file. ``probe`` prints the same text and
``encode`` writes the same bytes. Small frames: 96x128, nreslevels=3,
32x32 codeblocks. Also: the one-shot ``decode_frame_cuda``, the 17-bit
PatchWelcome, ``bench_resident`` at full resolution, ``--device cuda``
without a card, ``JXT_PROFILE`` and ``python -m``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ffmpeg_ht_tpu import cli as jax_cli
from ffmpeg_ht_tpu.models import host_decoder as jax_host
from ffmpeg_ht_tpu.utils.errors import PatchWelcome as JaxPatchWelcome
from ffmpeg_ht_tpu_torch import cli
from ffmpeg_ht_tpu_torch.containers import mov, mxf
from ffmpeg_ht_tpu_torch.models.decoder import Decoder, decode_frame_cuda
from ffmpeg_ht_tpu_torch.models.encoder import encode_frame_htj2k
from ffmpeg_ht_tpu_torch.utils.errors import PatchWelcome

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENC = dict(nreslevels=3, log2_cblk_width=5, log2_cblk_height=5)
RNG = np.random.default_rng(20261019)
GRAY = RNG.integers(0, 256, (96, 128), dtype=np.uint8)
RGB10 = RNG.integers(0, 1024, (96, 128, 3), dtype=np.uint16)
RGB8 = RNG.integers(0, 256, (96, 128, 3), dtype=np.uint8)
# kind -> (image, encoder options, MXF ncomp, MXF depth)
KINDS = {
    "gray_53": (GRAY, ENC, 1, 8),
    "rgb_53_rct": (RGB10, dict(ENC, depth=10, mct=True), 3, 10),
    "rgb_97i_ict": (RGB8, dict(ENC, pred=0, mct=True), 3, 8),
}
WRAPPERS = ("j2c", "mj2", "mxf")


def _write_input(tmp_path, kind, wrapper):
    """Two frames of `kind` (one for the raw J2C) in `wrapper`."""
    img, opts, ncomp, depth = KINDS[kind]
    frames = [encode_frame_htj2k(np.roll(img, k, 1), **opts)
              for k in (0, 5)]
    if wrapper == "j2c":
        data = frames[0]
    elif wrapper == "mj2":
        data = mov.mux_mj2(frames, 128, 96)
    else:
        data = mxf.mux_mxf(frames, 128, 96, ncomp=ncomp, depth=depth)
    path = tmp_path / f"{kind}.{wrapper}"
    path.write_bytes(data)
    return str(path)


@pytest.mark.parametrize("wrapper", WRAPPERS)
@pytest.mark.parametrize("kind", list(KINDS))
def test_decode_framemd5_matches_jax_host(kind, wrapper, tmp_path):
    src = _write_input(tmp_path, kind, wrapper)
    ours, ref = tmp_path / "ours.md5", tmp_path / "ref.md5"
    assert cli.main(["decode", src, "-f", "framemd5", "-o", str(ours),
                     "--device", "cpu"]) == 0
    assert jax_cli.main(["decode", src, "--host", "-f", "framemd5",
                         "-o", str(ref)]) == 0
    text = ours.read_text()
    assert text == ref.read_text()
    assert text.count("\n0,") == (1 if wrapper == "j2c" else 2)


@pytest.mark.parametrize("kind", list(KINDS))
def test_probe_matches_jax(kind, tmp_path, capsys):
    for wrapper in WRAPPERS:
        src = _write_input(tmp_path, kind, wrapper)
        assert cli.main(["probe", src]) == 0
        ours = capsys.readouterr().out
        assert jax_cli.main(["probe", src]) == 0
        assert ours == capsys.readouterr().out
        assert f"frames: {1 if wrapper == 'j2c' else 2}" in ours


# output name -> extra encode flags; pix_fmt and size below
ENCODES = {
    "out.j2k": ["--pix-fmt", "gray", "--tile-width", "64",
                "--tile-height", "64"],
    "out.jp2": ["--pix-fmt", "gray", "--codec", "j2k", "--jp2"],
    "gray.mxf": ["--pix-fmt", "gray"],
    "rgb.mxf": ["--pix-fmt", "rgb24"],
    "rgb.mj2": ["--pix-fmt", "rgb24", "--sop", "--eph"],
}


@pytest.mark.parametrize("name", list(ENCODES))
def test_encode_bytes_match_jax(name, tmp_path):
    flags = ENCODES[name]
    img = RGB8 if "rgb24" in flags else GRAY
    raw = tmp_path / "in.raw"
    raw.write_bytes(np.concatenate([img, np.roll(img, 3, 1)]).tobytes())
    ours, ref = tmp_path / f"ours_{name}", tmp_path / f"ref_{name}"
    args = [str(raw), "-s", "128x96", *flags]
    assert cli.main(["encode", *args, "-o", str(ours)]) == 0
    assert jax_cli.main(["encode", *args, "-o", str(ref)]) == 0
    assert ours.read_bytes() == ref.read_bytes()


def test_rawvideo_pix_fmt_and_host_match_jax(tmp_path):
    """`-f rawvideo --pix-fmt` through the port's Decoder, and the port's
    `--host` oracle, equal the JAX CLI's host output."""
    src = _write_input(tmp_path, "rgb_53_rct", "mxf")
    outs = {}
    for name, main, extra in (
            ("device", cli.main, ["--device", "cpu"]),
            ("host", cli.main, ["--host"]),
            ("jax", jax_cli.main, ["--host"])):
        path = tmp_path / f"{name}.raw"
        assert main(["decode", src, "--pix-fmt", "rgb24", "-o", str(path),
                     *extra]) == 0
        outs[name] = path.read_bytes()
    assert len(outs["jax"]) == 2 * 96 * 128 * 3
    assert outs["device"] == outs["host"] == outs["jax"]


def test_cuda_without_card_exits_nonzero(tmp_path, caplog):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    src = _write_input(tmp_path, "gray_53", "j2c")
    assert cli.main(["decode", src, "-f", "framemd5"]) == 1
    assert "torch.cuda.is_available() is False" in caplog.text


def test_benchmark_device_resident_and_profile(tmp_path, capsys,
                                               monkeypatch):
    """`--benchmark --device-resident` prints the resident rate; with
    JXT_PROFILE the decode writes a Chrome trace."""
    src = _write_input(tmp_path, "gray_53", "mxf")
    assert cli.main(["decode", src, "--benchmark", "--device-resident",
                     "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert "bench: device-resident" in err and "frames_merged=2" in err
    monkeypatch.setenv("JXT_PROFILE", str(tmp_path / "prof"))
    assert cli.main(["decode", src, "-f", "null", "--benchmark",
                     "--device", "cpu"]) == 0
    assert "bench: maxrss=" in capsys.readouterr().err
    with open(tmp_path / "prof" / "jxt_trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_python_m_runs(tmp_path):
    src = _write_input(tmp_path, "gray_53", "j2c")
    r = subprocess.run([sys.executable, "-m", "ffmpeg_ht_tpu_torch.cli",
                        "probe", src], capture_output=True, text=True,
                       cwd=REPO)
    assert r.returncode == 0 and "codec: htj2k" in r.stdout


def test_decode_frame_cuda_one_shot():
    data = encode_frame_htj2k(RGB10, **KINDS["rgb_53_rct"][1])
    fr = decode_frame_cuda(data, device="cpu")
    assert np.array_equal(fr.planes[0].reshape(RGB10.shape), RGB10 << 6)
    half = decode_frame_cuda(data, reduction_factor=1, device="cpu")
    assert half.tobytes() == jax_host.decode_frame(
        data, bitexact=True, reduction_factor=1).tobytes()


def test_17bit_stream_raises_patch_welcome():
    """No pixel format holds 17-bit samples: the port raises the
    reference's PatchWelcome before any program is built, on every entry
    point, as the JAX host oracle does."""
    img = RNG.integers(0, 1 << 17, (64, 64)).astype(np.uint32)
    data = encode_frame_htj2k(img, depth=17)
    with pytest.raises(JaxPatchWelcome) as want:
        jax_host.decode_frame(data, bitexact=True)
    dec = Decoder(device="cpu")
    for call in (lambda: dec.decode(data),
                 lambda: dec.decode_batch([data, data]),
                 lambda: dec.bench_resident([data], n_it=1, reps=1)):
        with pytest.raises(PatchWelcome) as got:
            call()
        assert str(got.value) == str(want.value) \
            == "Unknown pix_fmt: comps=1 precision=17 cs=0"
    assert (dec.v3_frames, dec.v2_frames, dec.host_frames) == (0, 0, 0)
    (fg,) = dec._geoms.values()
    assert not fg.v3_progs


def test_bench_resident_parses_at_full_resolution():
    """bench_resident times the full-resolution program whatever
    `reduction_factor` says (decoder.py:1009-1010)."""
    data = encode_frame_htj2k(GRAY, **ENC)
    dec = Decoder(device="cpu", reduction_factor=1)
    res = dec.bench_resident([data], n_it=1, reps=1)
    assert res["frames_merged"] == 1
    (fg,) = dec._geoms.values()
    (prog,) = fg.v3_progs.values()
    assert prog.total == 96 * 128 and not prog.wire_pack
    assert dec.decode(data).planes[0].shape == (48, 64)
