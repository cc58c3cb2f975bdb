"""The benchmark's plain reference of the lossy float 9/7 + ICT
configuration (``htbench/references/lossy97.py``) on the CPU: the port's
``decode_batch`` and ``decode_stream`` with ``bitexact=False``, and the
JAX package's decode of the same streams, agree with it within 1 LSB;
the control's frames (two bits cleared at the source) and the
reference's own inverse in float16 fail its ``judge``, here and at the
cell's 1920x1080. Its step sizes, derived in the reference from the
signalled exponents and mantissas, equal the port's, and its frames stay
within ``PSNR_DB`` of their source, which a step off by one of the 9/7
fold's factors does not.

Small streams: 192x128 8-bit RGB, irreversible 9/7 + ICT, 5 DWT levels,
32x32 codeblocks, from the benchmark's frozen encoder.
"""

import ast
import inspect

import numpy as np
import pytest
import torch

from ffmpeg_ht_tpu.models import host_decoder as jax_host
from ffmpeg_ht_tpu.models.decoder import Decoder as JaxDecoder
from ffmpeg_ht_tpu_torch.codestream.geometry import init_tile
from ffmpeg_ht_tpu_torch.codestream.parser import parse_codestream
from ffmpeg_ht_tpu_torch.models.decoder import Decoder
from ffmpeg_ht_tpu_torch.utils import trace
from htbench.content import natural
from htbench.frozen.models.encoder import encode_frame_htj2k
from htbench.references import lossy97

H, W, DEPTH = 128, 192, 8
ENC = dict(pred=0, mct=True, tile_width=256, tile_height=256,
           log2_cblk_width=5, log2_cblk_height=5, nreslevels=6)
SEEDS = (2 ** 31 + 5, 2 ** 33 + 11, 7)
# the reference's frames read 48.7-48.9 dB against their source, at
# 192x128 and at 1920x1080; one band's step off by a factor K reads
# under 38 dB, every step off by K under 34
PSNR_DB = 45.0


def _source(seed, h=H, w=W):
    return natural.make(np.random.default_rng([seed, 0]), h, w, 3, DEPTH)


def _psnr(got, want):
    mse = np.mean((got.astype(np.float64) - want.astype(np.float64)) ** 2)
    return 10 * np.log10(((1 << DEPTH) - 1) ** 2 / mse)


@pytest.fixture(scope="module")
def cases():
    """(sources, their streams, the reference's frames)."""
    srcs = [_source(s) for s in SEEDS]
    return (srcs, [encode_frame_htj2k(s, **ENC) for s in srcs],
            [lossy97.expected(s, DEPTH) for s in srcs])


def _judge(frame, want):
    return lossy97.judge(frame.planes, frame.width, frame.height, want)


@pytest.mark.parametrize("entry", ["decode_batch", "decode_stream"])
def test_port_is_within_1lsb_of_the_reference(cases, entry):
    _srcs, streams, want = cases
    dec = Decoder(device="cpu", bitexact=False)
    f0 = trace.counters.get("float97_frames", 0)
    got = dec.decode_batch(streams) if entry == "decode_batch" \
        else list(dec.decode_stream(streams))
    assert dec.v3_frames == len(streams) and not dec.host_frames
    assert trace.counters["float97_frames"] - f0 == len(streams)
    for frame, w in zip(got, want):
        n, widest = _judge(frame, w)
        assert n == 0 and widest <= lossy97.TOLERANCE


def test_reference_is_within_1lsb_of_the_jax_package(cases):
    _srcs, streams, want = cases
    for data, w in zip(streams, want):
        n, widest = _judge(jax_host.decode_frame(data, bitexact=False), w)
        assert n == 0 and widest <= lossy97.TOLERANCE
    frame = JaxDecoder(bitexact=False).decode(streams[0])
    n, widest = lossy97.judge([np.asarray(p) for p in frame.planes],
                              frame.width, frame.height, want[0])
    assert n == 0 and widest <= lossy97.TOLERANCE


def test_the_decode_is_lossy_and_the_source_is_no_reference(cases):
    srcs, _streams, want = cases
    for s, w in zip(srcs, want):
        assert lossy97.judge([s.reshape(H, -1)], W, H, w)[0] > 0


def test_control_frames_fail_judge(cases):
    srcs, _streams, want = cases
    for s, w in zip(srcs, want):
        low = lossy97.expected(lossy97.lower_precision(s, DEPTH), DEPTH)
        n, widest = lossy97.judge([low.reshape(H, -1)], W, H, w)
        assert n > 0 and widest > lossy97.TOLERANCE


@pytest.mark.parametrize("dtype,fails", [(torch.float16, True),
                                         (torch.float32, False)])
def test_the_inverse_a_precision_lower_fails_judge(cases, dtype, fails):
    """float16 moves 5-7% of the samples by 1 LSB (none further, so the
    share limit fails it); float32, the precision the configuration
    states, passes."""
    srcs, _streams, want = cases
    for s, w in zip(srcs, want):
        q, step = lossy97.quantized(s, DEPTH)
        got = lossy97.decode(q, step, DEPTH, dtype=dtype)
        n, widest = lossy97.judge([got.reshape(H, -1)], W, H, w)
        assert (n > 0) is fails and widest <= lossy97.TOLERANCE


@pytest.mark.parametrize("dtype,fails", [(torch.float16, True),
                                         (torch.float32, False)])
def test_the_inverse_a_precision_lower_fails_judge_at_1080p(dtype, fails):
    """The cell's size: float16 moves 5-6% of the samples by 1 LSB and
    none further, so only the share limit fails it; float32 passes."""
    src = _source(SEEDS[0], 1080, 1920)
    q, step = lossy97.quantized(src, DEPTH)
    want = lossy97.decode(q, step, DEPTH)
    got = lossy97.decode(q, step, DEPTH, dtype=dtype)
    n, widest = lossy97.judge([got.reshape(1080, -1)], 1920, 1080, want)
    assert (n > 0) is fails and widest <= lossy97.TOLERANCE


@pytest.mark.parametrize("k", range(len(SEEDS)))
def test_reference_steps_equal_the_port_s(cases, k):
    """Each band's step, from the exponent and mantissa that the stream
    signals, against the port's dequantization step of the same band."""
    hdr = parse_codestream(cases[1][k], bitexact=False)
    tile = init_tile(hdr, 0)
    for c, comp in enumerate(tile.comp):
        q = tile.qntsty[c]
        g = 0
        for r, rl in enumerate(comp.reslevel):
            for b, band in enumerate(rl.band):
                assert lossy97.band_step(q.expn[g], q.mant[g], DEPTH, r, b) \
                    == band.f_stepsize, (c, r, b)
                g += 1
        assert g == 3 * lossy97.NRESLEVELS - 2


def test_reference_frames_are_within_the_psnr_of_their_source(cases):
    srcs, _streams, want = cases
    for s, w in zip(srcs, want):
        assert _psnr(w, s) >= PSNR_DB


@pytest.mark.parametrize("band", ["LL", "all"])
def test_a_step_off_by_a_fold_factor_falls_below_the_psnr_bar(cases, band):
    """The PSNR bar sees a step size off by one factor K of the 9/7
    fold, in the LL band alone or in every band."""
    srcs, _streams, _want = cases
    q, step = lossy97.quantized(srcs[0], DEPTH)
    if band == "LL":
        step[:, :-(-H >> 5), :-(-W >> 5)] *= lossy97.K
    else:
        step *= lossy97.K
    assert _psnr(lossy97.decode(q, step, DEPTH), srcs[0]) < PSNR_DB


def test_judge_counts_a_frame_of_the_wrong_shape_wrong(cases):
    _srcs, _streams, want = cases
    assert lossy97.judge([want[0][:-1].reshape(H - 1, -1)], W, H - 1,
                         want[0]) == (want[0].size, None)


def test_reference_imports_neither_jax_nor_the_program():
    tree = ast.parse(inspect.getsource(lossy97))
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    tops = {n.split(".")[0] for n in names}
    assert tops <= {"__future__", "numpy", "torch", "htbench"}
    assert lossy97.DTYPE == torch.float64
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
