"""The port's copies of the framework-free output tier vs the JAX
package's: ``containers/`` (probe, demux, the MJ2 and MXF muxers, the
framecrc / framemd5 / rawvideo muxers), ``models/swscale`` and
``codestream/profiles``. Both sides run on the same inputs; the results
must be equal. Small frames only; nothing here compiles a JAX program.
"""

import numpy as np
import pytest

from ffmpeg_ht_tpu.codestream import profiles as jax_profiles
from ffmpeg_ht_tpu.containers import demux as jax_demux
from ffmpeg_ht_tpu.containers import mov as jax_mov
from ffmpeg_ht_tpu.containers import mux as jax_mux
from ffmpeg_ht_tpu.containers import mxf as jax_mxf
from ffmpeg_ht_tpu.models import host_decoder as jax_host
from ffmpeg_ht_tpu.models import swscale as jax_sws
from ffmpeg_ht_tpu_torch.codestream import profiles
from ffmpeg_ht_tpu_torch.containers import demux, mov, mux, mxf
from ffmpeg_ht_tpu_torch.containers.frame_parser import split_frames
from ffmpeg_ht_tpu_torch.models import host_decoder, swscale
from ffmpeg_ht_tpu_torch.models.encoder import (encode_frame_htj2k,
                                                encode_frame_t800)

RNG = np.random.default_rng(20261018)
IMGS = [RNG.integers(0, 256, (48, 64), dtype=np.uint8) for _ in range(3)]
FRAMES = [encode_frame_htj2k(i) for i in IMGS]


def _clip_wrapped():
    """MXF with all frames in one essence KLV (clip wrapping)."""
    one = jax_mxf.mux_mxf(FRAMES, 64, 48)
    i = one.find(bytes(jax_mxf._ELEM_J2K))
    clip = b"".join(FRAMES)
    return one[:i] + jax_mxf._ELEM_J2K + jax_mxf._ber4(len(clip)) + clip


CONTAINERS = {
    "j2k": lambda: FRAMES[0],
    "jp2": lambda: encode_frame_t800(IMGS[0], pred=1, jp2=True),
    "mjpeg_2000": lambda: b"".join(FRAMES),
    "mj2": lambda: mov.mux_mj2(FRAMES, 64, 48),
    "mxf": lambda: mxf.mux_mxf(FRAMES, 64, 48),
    "mxf_clip": _clip_wrapped,
}


@pytest.mark.parametrize("name", list(CONTAINERS))
def test_probe_and_demux_match_jax(name, tmp_path):
    data = CONTAINERS[name]()
    assert demux.probe_bytes(data) == jax_demux.probe_bytes(data)
    got = list(demux.demux_bytes(data))
    assert got == list(jax_demux.demux_bytes(data)) and got
    if name not in ("j2k", "jp2"):
        assert got == FRAMES
    path = tmp_path / f"in.{name}"
    path.write_bytes(data)
    assert demux.probe_file(str(path)) == jax_demux.probe_file(str(path))
    assert list(demux.demux_file(str(path))) == got


def test_muxers_and_image2_sequence_match_jax(tmp_path):
    """The MJ2 and MXF muxers write the same bytes, the MXF one for every
    layout option; an image2 %d sequence demuxes to the same frames; the
    frame parser resyncs past garbage (jpeg2000_parser.c:93)."""
    assert mov.mux_mj2(FRAMES, 64, 48) == jax_mov.mux_mj2(FRAMES, 64, 48)
    for kw in (dict(), dict(ncomp=3, depth=10),
               dict(ncomp=3, depth=8, chroma_shifts=(1, 1))):
        assert mxf.mux_mxf(FRAMES, 64, 48, **kw) == \
            jax_mxf.mux_mxf(FRAMES, 64, 48, **kw)
    assert mxf.probe_mxf(mxf.mux_mxf(FRAMES, 64, 48))
    for i, f in enumerate(FRAMES):
        (tmp_path / f"f{i:03d}.j2k").write_bytes(f)
    pattern = str(tmp_path / "f%03d.j2k")
    assert list(demux.demux_file(pattern)) == FRAMES \
        == list(jax_demux.demux_file(pattern))
    blob = b"garbage!" + FRAMES[0] + b"\x00\x01" + FRAMES[1]
    assert split_frames(blob)[:2] == FRAMES[:2]


# name -> (image, encoder options): decoded with each package's host
# oracle, then through each package's muxers
DECODED = {
    "gray8": (IMGS[0], {}),
    "gray16": (RNG.integers(0, 65536, (40, 56), dtype=np.uint16), {}),
    "rgb10": (RNG.integers(0, 1024, (40, 56, 3), dtype=np.uint16),
              dict(depth=10, mct=True)),
    "yuv420": ([RNG.integers(0, 256, (48, 64), dtype=np.uint8),
                RNG.integers(0, 256, (24, 32), dtype=np.uint8),
                RNG.integers(0, 256, (24, 32), dtype=np.uint8)],
               dict(chroma_shift=(1, 1))),
}


@pytest.mark.parametrize("name", list(DECODED))
def test_frame_muxers_match_jax(name):
    img, opts = DECODED[name]
    data = encode_frame_htj2k(img, **opts)
    ours = [host_decoder.decode_frame(data, bitexact=True)] * 2
    ref = [jax_host.decode_frame(data, bitexact=True)] * 2
    assert ours[0].fmt.name == ref[0].fmt.name
    for fn in ("framecrc", "framemd5", "rawvideo", "md5_total"):
        assert getattr(mux, fn)(ours) == getattr(jax_mux, fn)(ref), fn


def _frame(mod, name, rng):
    """A DecodedFrame of `mod` in pixel format `name`, random samples."""
    f = mod._fmt(name)
    h, w = 37, 30
    if f.planar:
        sizes = [(h, w)] + [(-(-h // (1 << f.log2_chroma_h)),
                             -(-w // (1 << f.log2_chroma_w)))] * 2
        sizes = sizes[:f.nb_components]
    else:
        sizes = [(h, w * f.nb_components)]
    dt = np.uint16 if f.bytes_per_sample == 2 else np.uint8
    planes = [rng.integers(0, 1 << f.depths[0], s).astype(dt)
              for s in sizes]
    return mod.DecodedFrame(fmt=f, width=w, height=h, planes=planes)


# the (source, destination) pairs of tests/test_swscale.py
SWS_PAIRS = [("gray", "rgb24"), ("rgb24", "gray"), ("gray", "gray16le"),
             ("gray16le", "gray"), ("rgb24", "rgb48le"),
             ("rgb48le", "rgb24"), ("yuv444p10le", "yuv444p"),
             ("yuv444p16le", "yuv444p"), ("yuv422p12le", "yuv422p"),
             ("yuv444p", "yuv444p16le"), ("rgb24", "yuv444p"),
             ("yuv444p", "rgb24"), ("rgb24", "yuv420p"),
             ("yuv420p", "rgb24")]


@pytest.mark.parametrize("src,dst", SWS_PAIRS)
def test_swscale_convert_matches_jax(src, dst):
    seed = SWS_PAIRS.index((src, dst))
    got = swscale.convert(_frame(swscale, src, np.random.default_rng(seed)),
                          dst)
    want = jax_sws.convert(_frame(jax_sws, src, np.random.default_rng(seed)),
                           dst)
    assert got.fmt.name == want.fmt.name == dst
    assert (got.width, got.height) == (want.width, want.height)
    assert len(got.planes) == len(want.planes)
    for a, b in zip(got.planes, want.planes):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_profile_name_matches_jax():
    for rsiz in list(range(0, 8)) + [0x4000, 0x4003, 0x4004, 0x4107,
                                     0x8000, 0xC001]:
        assert profiles.profile_name(rsiz) == \
            jax_profiles.profile_name(rsiz)
