"""SigProp + MagRef: the port's ``refine_ref`` vs the JAX package.

The same lanes (numpy, seeded) go through ``ffmpeg_ht_tpu.ops.ht_refine.
decode_refinement_scan`` and the port's ``ops/ht_refine.refine_ref``; the
match is exact. The lanes are codeblocks made by the port's
``encode_block_3pass`` with z_blk in {1, 2, 3} mixed in one bucket, at the
shapes of tests/test_ht_refine.py (32x32 and 17x29; causal at 32x32 and
20x19); their cleanup output comes from the port's ``cleanup_ref``
(pinned against the JAX cleanup elsewhere). Both are also held against
the scalar oracle ``decode_htj2k``. On random refinement bits the port
follows the oracle where the JAX function leaves out the above-right
neighbour on a stripe's first row (see the ops/ht_refine docstring).
``refine_ref`` is the composition of the two passes' plain halves,
``magref_pass_ref`` merging ``sigprop_pass_ref``'s words; the halves are
also run one by one and held against the same references, and the
wrappers of the two kernels take them for CPU tensors. CPU tensors never
launch a CUDA kernel.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ffmpeg_ht_tpu.ops.ht_refine import decode_refinement_scan as jax_refine
from ffmpeg_ht_tpu_torch.ops import ht_refine
from ffmpeg_ht_tpu_torch.ops.ht_batch import (prepare_magref_stream,
                                              prepare_sigprop_stream,
                                              prepare_streams_batch,
                                              stream_limits)
from ffmpeg_ht_tpu_torch.ops.ht_dec import decode_htj2k
from ffmpeg_ht_tpu_torch.ops.ht_enc import encode_block_3pass
from ffmpeg_ht_tpu_torch.ops.ht_scan import cleanup_ref

MAGB = 8
ZBP = MAGB - 2
LANES = 12                 # lanes per bucket (fixed: one JAX compile a shape)
WORDS = 96                 # SigProp / MagRef words per lane (zero padded)


def _blocks(rng, w, h, causal, npasses_cycle, sparsity=None):
    """(data, lcup, lref, npasses) codeblocks from encode_block_3pass."""
    out = []
    while len(out) < LANES:
        mag = rng.integers(0, 128, (h, w)).astype(np.int64)
        p = rng.random() if sparsity is None else sparsity
        mag = np.where(rng.random((h, w)) < p, 0, mag)
        sign = np.where(mag > 0, rng.integers(0, 2, (h, w)), 0)
        enc = encode_block_3pass(mag, sign.astype(np.int64), ZBP,
                                 is_causal=int(causal))
        if enc is None:
            continue
        data, lcup, lref = enc
        out.append((data, lcup, lref,
                    npasses_cycle[len(out) % len(npasses_cycle)]))
    return out


def lane_arrays(blocks, w, h, causal):
    """The refinement kernel's inputs for `blocks` as numpy arrays (uint32
    words, int32 / bool vectors), cleanup decoded by ``cleanup_ref``."""
    n = len(blocks)
    qw, qh = -(-w // 2), -(-h // 2)
    cdat = np.zeros((n, max(len(d) for d, *_ in blocks)), np.uint8)
    dref = np.zeros((n, max(max(lr for _, _, lr, _ in blocks), 4)), np.uint8)
    lcups, pcups, lrefs = (np.zeros(n, np.int64) for _ in range(3))
    npasses = np.array([b[3] for b in blocks])
    for i, (data, lcup, lref, npass) in enumerate(blocks):
        buf = bytearray(data[:lcup])
        scup = (buf[lcup - 1] << 4) + (buf[lcup - 2] & 0x0F)
        buf[lcup - 1] = 0xFF
        buf[lcup - 2] |= 0x0F
        cdat[i, :lcup] = np.frombuffer(bytes(buf), np.uint8)
        lcups[i], pcups[i] = lcup, lcup - scup
        if npass > 1:
            dr = data[lcup:lcup + lref]
            dref[i, :len(dr)] = np.frombuffer(dr, np.uint8)
            lrefs[i] = lref
    msw, melw, vlcw = prepare_streams_batch(cdat, lcups, pcups)
    ms_lim, mel_lim = stream_limits(cdat, lcups, pcups)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                                   if a.dtype == np.uint32
                                   else a.astype(np.int32))
    full = torch.full((n,), 1, dtype=torch.int32)
    mu, sig, ok = cleanup_ref(t(msw), t(melw), t(vlcw),
                              full * (30 - ZBP), full * (ZBP + 1), t(ms_lim),
                              t(mel_lim), full * qw, full * qh, qw, qh,
                              ZBP + 1)
    assert bool(ok.all())

    def words(a):
        out = np.zeros((n, WORDS), np.uint32)
        out[:, :a.shape[1]] = a
        return out
    return dict(mu=mu.numpy().view(np.uint32), sig=sig.numpy(),
                spw=words(prepare_sigprop_stream(dref, lrefs)),
                mrw=words(prepare_magref_stream(dref, lrefs)),
                pLSB=np.full(n, 30 - ZBP, np.int32),
                has_sp=npasses >= 2, has_mr=npasses >= 3,
                causal=np.full(n, bool(causal)))


def run_port(a, w, h):
    t = {k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32
                             else v) for k, v in a.items()}
    qw, qh = -(-w // 2), -(-h // 2)
    out = ht_refine.decode_refinement_scan(
        t["mu"], t["sig"], t["spw"], t["mrw"], t["pLSB"], t["has_sp"],
        t["has_mr"], t["causal"], qw, qh, w, h)
    assert out.dtype == torch.int32 and out.shape == (len(a["pLSB"]), 2 * qh,
                                                      2 * qw)
    return out.numpy().view(np.uint32)


def run_halves(a, w, h):
    """SigProp then MagRef through the two kernels' wrappers on CPU
    tensors (their plain halves), checked against the halves called
    directly: (refined samples, SigProp's REF and sign bits (N, 2qh,
    2qw))."""
    t = {k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32
                             else v) for k, v in a.items()}
    qw, qh = -(-w // 2), -(-h // 2)
    s_in = (t["sig"], t["spw"], t["has_sp"], t["causal"], qw, qh, w, h)
    words = ht_refine.sigprop_pass_ref(*s_in)
    assert torch.equal(ht_refine.ht_sigprop_pass(*s_in), words)
    m_in = (t["mu"], t["sig"], t["mrw"], t["pLSB"], t["has_mr"], words, qw,
            qh, w, h)
    got = ht_refine.magref_pass_ref(*m_in)
    assert torch.equal(ht_refine.ht_magref_pass(*m_in), got)
    return got.numpy().view(np.uint32), ht_refine._unpack_words(words, qw,
                                                                qh)


def run_jax(a, w, h):
    j = {k: jnp.asarray(v) for k, v in a.items()}
    return np.asarray(jax_refine(**j, qw=-(-w // 2), qh=-(-h // 2), w=w,
                                 h=h))


def oracle(blocks, w, h, causal):
    return [decode_htj2k(d, npass, ZBP, [lcup, lref], w, h, MAGB, 0,
                         int(causal)).view(np.uint32)
            for d, lcup, lref, npass in blocks]


@pytest.mark.parametrize("w,h,causal", [(32, 32, False), (17, 29, False),
                                        (32, 32, True), (20, 19, True)])
def test_refine_ref_matches_jax_and_oracle(w, h, causal):
    """Mixed z_blk (3, 2, 1; causal lanes all 3) in one bucket: the port's
    refinement equals the JAX function and the oracle, bit for bit, and is
    zero outside the codeblock; CPU tensors launch nothing."""
    rng = np.random.default_rng(w * 100 + h + causal)
    blocks = _blocks(rng, w, h, causal, (3,) if causal else (3, 2, 1),
                     0.6 if causal else None)
    a = lane_arrays(blocks, w, h, causal)
    before = ht_refine.decode_refinement_scan.launches
    got = run_port(a, w, h)
    assert ht_refine.decode_refinement_scan.launches == before
    assert np.array_equal(got, run_jax(a, w, h))
    assert not got[:, h:].any() and not got[:, :, w:].any()
    for i, want in enumerate(oracle(blocks, w, h, causal)):
        assert np.array_equal(got[i, :h, :w], want), f"lane {i}"
    if causal:
        # the flag takes effect: decoded as non-causal, some lane differs
        nc = dict(a, causal=np.zeros_like(a["causal"]))
        assert not np.array_equal(run_port(nc, w, h), got)


@pytest.mark.parametrize("w,h,causal,random_bits", [
    (32, 32, False, False), (17, 29, False, False), (32, 32, True, False),
    (20, 19, True, False), (32, 32, False, True)])
def test_refine_halves_compose_to_refine_ref(w, h, causal, random_bits):
    """magref_pass_ref merging sigprop_pass_ref's words equals refine_ref
    and the oracle on every lane; on the encoder's streams also the JAX
    function; on random refinement bits (after the encoder's cleanup
    segments) the JAX function departs, as in the test below. The words
    hold exactly the samples SigProp made significant (inside the
    codeblock, insignificant after the cleanup, their pLSB bit set in the
    result) and their signs."""
    rng = np.random.default_rng(w * 100 + h + causal + 7 * random_bits)
    blocks = _blocks(rng, w, h, causal, (3,) if causal or random_bits
                     else (3, 2, 1), 0.9 if random_bits else
                     0.6 if causal else None)
    if random_bits:
        blocks = [(bytes(d[:lcup]) + rng.integers(0, 256, 200, np.uint8)
                   .tobytes(), lcup, 200, int(rng.choice([2, 3])))
                  for d, lcup, _lref, _ in blocks]
    a = lane_arrays(blocks, w, h, causal)
    got, (ref, sgn) = run_halves(a, w, h)
    assert np.array_equal(got, run_port(a, w, h))
    for i, want in enumerate(oracle(blocks, w, h, causal)):
        assert np.array_equal(got[i, :h, :w], want), f"lane {i}"
    assert np.array_equal(run_jax(a, w, h), got) != random_bits
    qw, qh = -(-w // 2), -(-h // 2)
    sig_px = (np.repeat(np.repeat(a["sig"], 2, 1), 2, 2)
              >> ((np.arange(2 * qh)[:, None] & 1)
                  + 2 * (np.arange(2 * qw)[None] & 1))) & 1
    inside = np.zeros((2 * qh, 2 * qw), bool)
    inside[:h, :w] = True
    ref, sgn = ref.numpy() == 1, sgn.numpy() == 1
    assert ref.any() and not (ref & ~(inside & (sig_px == 0))).any()
    assert not (sgn & ~ref).any()
    pL = (a["pLSB"][:, None, None] - 1).astype(np.uint32)
    assert np.array_equal(ref[:, :h, :w] & (sig_px[:, :h, :w] == 0),
                          ((got >> pL) & 1 == 1)[:, :h, :w]
                          & (sig_px[:, :h, :w] == 0))
    assert np.array_equal(sgn, ref & (got >> 31 == 1))


def test_refine_ref_random_bits_follow_the_oracle():
    """Random SigProp / MagRef bytes after encoded cleanup segments: the
    port equals the oracle on every lane; the JAX function, which leaves
    the above-right REF out on stripe-first rows, departs from both."""
    w = h = 32
    rng = np.random.default_rng(77)
    blocks = []
    for data, lcup, _lref, _ in _blocks(rng, w, h, False, (3,), 0.9):
        lref = 200
        blocks.append((bytes(data[:lcup]) + rng.integers(
            0, 256, lref, dtype=np.uint8).tobytes(), lcup, lref,
            int(rng.choice([2, 3]))))
    a = lane_arrays(blocks, w, h, False)
    got = run_port(a, w, h)
    for i, want in enumerate(oracle(blocks, w, h, False)):
        assert np.array_equal(got[i, :h, :w], want), f"lane {i}"
    assert not np.array_equal(run_jax(a, w, h), got)
