"""The port's own host tier vs the JAX package's.

``ffmpeg_ht_tpu_torch`` carries a copy of every framework-free module it
uses (codestream parse and T2, the native tier, stream prep, lane
building, the host oracle, the encoder). The copies must give the same
bytes and arrays as the originals on the same inputs, and nothing in the
port, nor ``chip_smoke.py`` or the port's tools, may import
``jax`` or the JAX package at any level. The v3 lane build departs
from the copy: its arguments must still equal the JAX package's bit for
bit, on the conformance corpus's v3 streams, batches, oracle lanes, the
benchmark's cells cut to 64x64 and corrupt Scups. Small streams only.
"""

import ast
import os

import numpy as np
import pytest

from ffmpeg_ht_tpu.codestream.parser import parse_codestream as jax_parse
from ffmpeg_ht_tpu.models import encoder as jax_enc
from ffmpeg_ht_tpu.models import fastpath as jax_fp
from ffmpeg_ht_tpu.models import host_decoder as jax_host
from ffmpeg_ht_tpu.utils.errors import InvalidData as JaxInvalidData
from ffmpeg_ht_tpu_torch.codestream.parser import parse_codestream
from ffmpeg_ht_tpu_torch.models import encoder as port_enc
from ffmpeg_ht_tpu_torch.models import fastpath as port_fp
from ffmpeg_ht_tpu_torch.models import host_decoder as port_host
from ffmpeg_ht_tpu_torch.utils import native
from ffmpeg_ht_tpu_torch.utils.errors import InvalidData

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
    assert np.array_equal(_byte_matrix(fc), jfc["data"])
    for k in ("lcups", "pcups", "qws", "qhs", "pLSB", "maxbp"):
        assert np.array_equal(fc[k], jfc[k]), k
    assert len(fc["host_pf"]) == len(jfc["host_pf"])
    want, _ = jax_fp.finish_v3(jfg, [jfc], jfg.geom.total)
    got, _ = port_fp.finish_v3_numpy(fg, [fc], fg.geom.total)
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k


def _byte_matrix(fc):
    """The JAX package's (N, Lmax) lane byte matrix from the port's
    columns: the padded gather from the body and the device lanes'
    modDcup, as the JAX ``build_v3_frame`` builds it."""
    dev, lcups, off = fc["dev"], fc["lcups"], fc["off"]
    lmax = max(int(lcups[dev].max()) if dev.any() else 4, 4)
    body_pad = np.concatenate([fc["body"], np.zeros(lmax + 8, np.uint8)])
    data = body_pad[off[:, None] + np.arange(lmax)[None, :]]
    ar = np.arange(len(off))
    data[ar, lcups - 1] = np.where(dev, 0xFF, data[ar, lcups - 1])
    data[ar, lcups - 2] = np.where(dev, data[ar, lcups - 2] | 0x0F,
                                   data[ar, lcups - 2])
    return data


def _gray_frames():
    """Four 96x128 gray frames of one geometry whose longest lanes differ:
    full-range noise, low-amplitude noise, a ramp, noise above flat."""
    rng = np.random.default_rng(41)
    ramp = (np.arange(128)[None, :] + np.arange(96)[:, None]).astype(
        np.uint8)
    half = rng.integers(0, 256, (96, 128), dtype=np.uint8)
    half[48:] = 9
    return [rng.integers(0, 256, (96, 128), dtype=np.uint8),
            (120 + rng.integers(0, 9, (96, 128))).astype(np.uint8),
            ramp, half]


def _long_tail_image():
    """One noisy 16x16 codeblock among 63 near-empty ones: the long-tail
    policy sends its lane to the scalar oracle."""
    img = np.full((128, 128), 128, np.uint8)
    img[::16, ::16] = 129
    img[16:32, 16:32] = np.random.default_rng(7).integers(0, 256, (16, 16))
    return img


def _tiny_streams(like):
    """The four frames of ``htbench/tests/tiny.py``'s cut of a cell."""
    from htbench import inputs
    from htbench.frozen.models.encoder import encode_frame_htj2k
    from htbench.tests.tiny import tiny_cell
    cell = tiny_cell(like)
    return [encode_frame_htj2k(inputs.make_source(cell.config, cell.traffic,
                                                  2 ** 31 + 77, i),
                               **cell.config["encoder"])
            for i in range(cell.traffic["distinct"])]


def _dev_lane(cols, fp, parse, data, opts, small=False):
    """An active lane the v3 build keeps on the device (the shortest one
    when `small`)."""
    hdr = parse(data, **opts)
    fc = fp.build_v3_frame(fp.FlatGeometry(hdr), cols)
    dev = np.nonzero(fc["qws"] > 0)[0]
    return int(dev[np.argmin(fc["lcups"][dev])] if small else dev[0])


def _set_scup(cols, lane, last, prev_nibble):
    """cols with lane's last byte `last` and the nibble under it."""
    body = bytearray(cols["body"])
    p = int(cols["off"][lane] + cols["lcup"][lane])
    body[p - 1] = last
    body[p - 2] = (body[p - 2] & 0xF0) | prev_nibble
    return dict(cols, body=bytes(body))


def _scup_case(kind):
    """(stream, the mutation of its columns) for a corrupt-Scup case."""
    data = jax_enc.encode_frame_htj2k(GRAY8, **ENC)

    def mutate(cols, fp, parse):
        lane = _dev_lane(cols, fp, parse, data, dict(bitexact=True),
                         small=kind == "over-lcup")
        lcup = int(cols["lcup"][lane])
        if kind == "below-2":
            return _set_scup(cols, lane, 0, 1)
        if kind == "over-lcup":
            return _set_scup(cols, lane, min(lcup // 16 + 1, 0xFE), 0xF)
        if kind == "over-4079":
            return _set_scup(cols, lane, 0xFF, 0)
        if kind == "rewritten-valid":
            return _set_scup(cols, lane, 0, 2)
        # past-body: the body ends one byte into the last lane's tail, so
        # its Scup byte reads 0
        end = cols["off"] + cols["lcup"]
        last = int(np.argmax(np.where(cols["active"], end, -1)))
        return dict(cols, body=bytes(cols["body"][:int(end[last]) - 1]))
    return [data], mutate


def _deep_lane(cols, fp, parse):
    """A lane whose zbp_eff + 1 exceeds 25 (the encoder cannot make one):
    the v3 build sends it to the scalar oracle."""
    act = np.nonzero(cols["active"])[0]
    cols = dict(cols, zbp=cols["zbp"].copy())
    cols["zbp"][act[1]] = 25
    return cols


def _lane_cases():
    """{id: (streams of one geometry, parse options, columns mutation)}."""
    from test_torch_conformance import CORPUS, encode
    cases = {}
    for c in CORPUS:
        if c.route == "v3":
            cases[f"corpus-{c.name}"] = ([encode(c)], dict(
                bitexact=c.dec.get("bitexact", True),
                reduction_factor=c.dec.get("reduction_factor", 0)), None)
    gray = [jax_enc.encode_frame_htj2k(x, **ENC) for x in _gray_frames()]
    exact = dict(bitexact=True)
    cases["frames2-lmax"] = (gray[:2], exact, None)
    cases["frames4-lmax"] = (gray, exact, None)
    cases["oracle-long-tail"] = ([jax_enc.encode_frame_htj2k(
        _long_tail_image(), nreslevels=1, log2_cblk_width=4,
        log2_cblk_height=4)], exact, None)
    cases["oracle-deep-lane"] = (gray[:1], exact, _deep_lane)
    for like in ("c3-stream-natural", "c1-batch16-natural",
                 "c3-batch4-grain"):
        cases[f"tiny-{like}"] = (like, exact, None)
    for kind in SCUP_RAISES + ("rewritten-valid", "past-body"):
        cases[f"scup-{kind}"] = (kind, exact, "scup")
    return cases


# the Scup corruptions the JAX package rejects (scup < 2, > lcup, > 4079)
SCUP_RAISES = ("below-2", "over-lcup", "over-4079")


LANE_CASES = _lane_cases()


def _v3_lanes(fp, parse, streams, opts, mutate):
    """(FlatGeometry, every stream's ``build_v3_frame`` columns), or the
    InvalidData the build raised."""
    fg = None
    frames = []
    for data in streams:
        hdr = parse(data, **opts)
        fg = fg or fp.FlatGeometry(hdr)
        cols = fp.parse_frame_flat(hdr, fg)
        if mutate is not None:
            cols = mutate(cols, fp, parse)
        try:
            frames.append(fp.build_v3_frame(fg, cols))
        except (InvalidData, JaxInvalidData) as e:
            return fg, e
    return fg, frames


@pytest.mark.parametrize("case", list(LANE_CASES))
def test_v3_lane_args_equal_jax(case):
    """The port's finish_v3_numpy(build_v3_frame(...)), the direct pass
    from the codestream bodies, against the JAX package's finish_v3 of its
    byte matrix: every argument equal in dtype, shape and bits, for one to
    four frames of unequal longest lanes, with lanes sent to the oracle;
    a corrupt Scup raises InvalidData in the port exactly where it does in
    the JAX package."""
    streams, opts, mutate = LANE_CASES[case]
    if mutate == "scup":
        streams, mutate = _scup_case(streams)
    elif isinstance(streams, str):
        streams = _tiny_streams(streams)
    fg, frames = _v3_lanes(port_fp, parse_codestream, streams, opts, mutate)
    jfg, jframes = _v3_lanes(jax_fp, jax_parse, streams, opts, mutate)
    if case in [f"scup-{k}" for k in SCUP_RAISES]:
        assert isinstance(jframes, JaxInvalidData), jframes
    if isinstance(jframes, Exception):
        assert isinstance(jframes, JaxInvalidData)
        assert isinstance(frames, InvalidData), case
        assert str(frames) == str(jframes)
        return
    assert not isinstance(frames, Exception), frames
    assert all(f is not None for f in frames)
    if case.startswith("oracle"):
        assert any(len(f["host_pf"]) for f in frames)
    if len(frames) > 1:
        lmax = {int(f["lcups"][f["dev"]].max()) for f in frames}
        assert len(lmax) > 1
    want, F = jax_fp.finish_v3(jfg, jframes, jfg.geom.total)
    got, F2 = port_fp.finish_v3_numpy(fg, frames, fg.geom.total)
    assert F == F2 == len(streams) and set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert np.array_equal(got[k], w), k


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


# ---- the native stream packers

def _rows(kind, n=48, lmax=40):
    """(data (n, lmax) uint8, lcup, pcup) of seeded rows: `kind` picks the
    bytes; the first rows hold MEL and VLC segments of 0, 1 and 2 bytes,
    and whole rows of 0, 1 and 2 bytes."""
    rng = np.random.default_rng(["random", "ff-runs", "stuffing",
                                 "zero-tails"].index(kind))
    if kind == "random":
        data = rng.integers(0, 256, (n, lmax))
    elif kind == "ff-runs":
        data = np.where(rng.random((n, lmax)) < 0.6, 0xFF,
                        rng.integers(0, 256, (n, lmax)))
    elif kind == "stuffing":
        data = rng.choice([0xFF, 0x7F, 0x8F, 0x90, 0xF0, 0xFE, 0x80, 0],
                          (n, lmax))
    else:
        data = rng.integers(0, 256, (n, lmax))
        data[np.arange(lmax)[None, :] < rng.integers(0, lmax, n)[:, None]] = 0
    lcup = rng.integers(0, lmax + 1, n)
    pcup = (rng.random(n) * (lcup + 1)).astype(np.int64)
    lcup[:6] = [0, 1, 2, 9, 10, 11]
    pcup[:6] = [0, 0, 0, 9, 9, 9]
    return data.astype(np.uint8), lcup.astype(np.int64), pcup


def _mel_bits(seg):
    """The MEL stream of `seg` a bit at a time: each 7/8-bit payload
    MSB first, then 64 ones."""
    bits, prev = [], 0
    for b in seg:
        nbits = 7 if prev == 0xFF else 8
        bits += [(int(b) >> j) & 1 for j in range(nbits - 1, -1, -1)]
        prev = b
    return bits + [1] * 64


PACK_KINDS = ("random", "ff-runs", "stuffing", "zero-tails")


@pytest.mark.parametrize("kind", PACK_KINDS)
def test_native_prep_matches_the_bit_serial_packer(kind):
    """The port's word packers (a word of four bytes at a time, MEL by
    reversing each byte's bits) against the JAX package's native prep,
    which packs MEL a bit at a time, and against the MEL stream built bit
    by bit here: the same words and limits."""
    from ffmpeg_ht_tpu.utils import native as jax_native
    data, lcup, pcup = _rows(kind)
    got = native.ht_prepare_streams(data, lcup, pcup, want_limits=True)
    want = jax_native.ht_prepare_streams(data, lcup, pcup, want_limits=True)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    melw, mel_lim = got[1], got[4]
    for i in range(len(data)):
        bits = _mel_bits(data[i, pcup[i]:lcup[i]])
        row = np.unpackbits(melw[i].view(np.uint8), bitorder="little")
        assert row[:len(bits)].tolist() == bits, i
        assert not row[len(bits):].any() and mel_lim[i] == len(bits) // 32


@pytest.mark.parametrize("kind", PACK_KINDS)
@pytest.mark.parametrize("frames", [1, 3])
def test_direct_v3_pass_matches_the_byte_matrix_prep(kind, frames):
    """ht_prepare_v3 reading lanes from frame bodies (gaps between lanes,
    a body cut inside its last lanes, modDcup on some rows) gives the
    words and limits of ht_prepare_streams on the padded byte matrix,
    with every stream at the width _trim_pow2 picks."""
    data, lcup, pcup = _rows(kind, n=16 * frames)
    rng = np.random.default_rng(frames)
    mod = rng.random(len(data)) < 0.5
    bodies, off = [], np.zeros(len(data), np.int64)
    for f in range(frames):
        parts, pos = [], 0
        for r in range(16 * f, 16 * (f + 1)):
            gap = rng.integers(0, 256, int(rng.integers(0, 4)), np.uint8)
            parts += [gap, data[r, :lcup[r]]]
            off[r] = pos + len(gap)
            pos = off[r] + lcup[r]
        body = np.concatenate(parts)
        bodies.append(body[:len(body) - 5] if f == frames - 1 else body)
    ref = np.zeros((len(data), max(int(lcup.max()), 4)), np.uint8)
    for r in range(len(data)):
        body = bodies[r // 16]
        for j in range(lcup[r]):
            ref[r, j] = body[off[r] + j] if off[r] + j < len(body) else 0
        if mod[r] and lcup[r] >= 2:
            ref[r, lcup[r] - 1] = 0xFF
            ref[r, lcup[r] - 2] |= 0x0F
    want = native.ht_prepare_streams(ref, lcup, pcup, want_limits=True)
    got = native.ht_prepare_v3(bodies, off, lcup, pcup, mod)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


@pytest.mark.parametrize("kind", PACK_KINDS)
def test_direct_pass_reads_runs_of_rows_from_each_body(kind):
    """With ``counts``, body k holds the next counts[k] rows, in runs of
    unequal length, one of them empty, and an empty body's rows read
    zeros (a BucketProgram bucket's pad lanes): the words and limits of
    ht_prepare_streams on the byte matrix of the same rows."""
    data, lcup, pcup = _rows(kind, n=24)
    counts = [7, 0, 12, 5]
    bodies, off, r = [], np.zeros(len(data), np.int64), 0
    for c in counts[:-1]:
        parts, pos = [], 0
        for i in range(r, r + c):
            parts.append(data[i, :lcup[i]])
            off[i], pos = pos, pos + lcup[i]
        bodies.append(np.concatenate(parts) if parts
                      else np.zeros(0, np.uint8))
        r += c
    bodies.append(np.zeros(0, np.uint8))
    lcup[r:], pcup[r:] = 2, 0
    mod = np.arange(len(data)) % 3 == 0
    ref = np.zeros_like(data)
    for i in range(r):
        ref[i, :lcup[i]] = data[i, :lcup[i]]
    for i in np.nonzero(mod & (lcup >= 2))[0]:
        ref[i, lcup[i] - 1] = 0xFF
        ref[i, lcup[i] - 2] |= 0x0F
    want = native.ht_prepare_streams(ref, lcup, pcup, want_limits=True)
    got = native.ht_prepare_v3(bodies, off, lcup, pcup, mod, counts=counts)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    with pytest.raises(ValueError):
        native.ht_prepare_v3(bodies, off, lcup, pcup, mod, counts=[7, 12])


def _out_cases():
    """`out` callables: (name, the callable, True where it must raise)."""
    def fill(shapes):           # every word a pattern the pack overwrites
        return [np.full(s, 0xA5A5A5A5, np.uint32) for s in shapes]

    def narrow(shapes):
        return [np.zeros((r, w - 1), np.uint32) for r, w in shapes]

    def short(shapes):
        return [np.zeros((r - 1, w), np.uint32) for r, w in shapes]

    def signed(shapes):
        return [np.zeros(s, np.int32) for s in shapes]

    def strided(shapes):
        return [np.zeros((r, 2 * w), np.uint32)[:, ::2] for r, w in shapes]

    def two(shapes):
        return fill(shapes)[:2]
    return [("fill", fill, False), ("narrow", narrow, True),
            ("short", short, True), ("signed", signed, True),
            ("strided", strided, True), ("two", two, True)]


@pytest.mark.parametrize("case", [c[0] for c in _out_cases()])
@pytest.mark.parametrize("kind", PACK_KINDS)
def test_direct_v3_pass_packs_into_the_callers_arrays(kind, case):
    """With ``out``, ht_prepare_v3 hands the callable the three word
    arrays' shapes and packs into what it returns: arrays filled with a
    pattern first end equal to the allocating call's, the zero padding
    past each stream included; an output too small (a word or a row
    short), of another dtype, not C-contiguous or missing raises."""
    (_name, out, raises), = [c for c in _out_cases() if c[0] == case]
    data, lcup, pcup = _rows(kind, n=24)
    body = np.concatenate([data[i, :lcup[i]] for i in range(24)])
    off = np.concatenate([[0], np.cumsum(lcup[:-1])]).astype(np.int64)
    mod = np.arange(24) % 2 == 0
    want = native.ht_prepare_v3([body], off, lcup, pcup, mod)
    seen = []
    call = lambda: native.ht_prepare_v3(
        [body], off, lcup, pcup, mod,
        out=lambda shapes: seen.append(shapes) or out(shapes))
    if raises:
        with pytest.raises(ValueError):
            call()
        return
    got = call()
    assert seen == [[w.shape for w in want[:3]]]
    assert any(not w[:, -1].any() for w in want[:3])   # padding words
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_direct_v3_pass_rejects_bad_rows():
    body = np.zeros(8, np.uint8)
    one = np.ones(1, np.int64)
    with pytest.raises(ValueError):
        native.ht_prepare_v3([body], one * 0, one * 2, one * 3, one > 0)
    with pytest.raises(ValueError):
        native.ht_prepare_v3([body, body], one * 0, one * 2, one * 0,
                             one > 0)
