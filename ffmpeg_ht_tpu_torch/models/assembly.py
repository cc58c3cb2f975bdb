"""The device programs in PyTorch: the v3 fused program (counterpart of
``ffmpeg_ht_tpu.models.assembly.make_v3_program``) and the v2 bucketed
program (counterpart of ``_entropy_stage`` + ``_compiled_assembly`` of
``ffmpeg_ht_tpu.models.decoder``).

``V3Program``, per call, for F frames of one geometry:

  1. one HT cleanup launch over every codeblock lane (ops/ht_scan);
  2. dequant of the mu words (jpeg2000dec.c:2098-2181): reversible (5/3),
     integer 9/7 (Q16 ``scale97``, int64 products) or float 9/7
     (``fscale``, float32 lane rasters);
  3. the sparse prefill scatter of host-decoded lanes;
  4. the band mosaics: every subband cut out of the lane rasters
     (``AssemblyPlan`` from ``build_plan`` below);
  5. the inverse DWT of every level of every plane (a level under 8 in
     a dimension is a small job, the others band-direct lifting);
  6. RCT (5/3, a launch per frame) or ICT (9/7, one launch for the F
     frames) + DC shift + clip written straight into the output
     (ops/mct_cuda), and ``rint`` (float) + DC shift + clip of every
     plane without MCT in one ``plane_writeframe`` call, every sample
     where the program's ``FrameLayout`` puts it: the frame of the
     negotiated pixel format (R, G, B interleaved in ``rgb48le``, shifted
     to 16 bits, each tile at its place), so that the host copies each
     plane out once; or the tile-component planes back to back
     (``FrameLayout.identity``);
  7. one uint8 / uint16 buffer (uint16 held as int16 bits) of the F
     frames whose last element is the all-lanes ok flag; with
     ``wire_pack`` (9..15-bit samples, identity layout) that buffer is
     bit-packed into int32 words holding uint32 bits, followed by the
     flag as one word (ops/wirepack, the kernel ``csrc/wire_pack.cu``),
     as the reference's ``wire_pack`` option does (assembly.py:436-441,
     decoder.py:595-601).

Stages 2-4 are one call of ``ops/coef_cuda.coef_mosaic`` for the F
frames (the kernel ``csrc/coef_mosaic.cu`` on the card) into one band
buffer laid out by a ``CoefLayout`` built once per program, and stage 5
is one call of ``ops/dwt_cuda.dwt_lift_program`` for every level of every
plane of every frame, from a ``LiftPlan`` built beside the layout (the
kernels ``csrc/dwt_small.cu``, a launch for the levels under 8x8, where
the JAX program takes its flat fallback, and ``csrc/dwt_lift.cu``, a
launch a level); CPU tensors take their plain versions, the torch ops of
ops/coef_cuda, ops/dwt_torch and ops/mct_cuda.

``BucketProgram`` runs the cleanup per bucket of same-shape codeblocks
(plus SigProp / MagRef, ops/ht_refine, on refined buckets); one
``bucket_scatter`` call (the kernel ``csrc/bucket_scatter.cu``) for the
dequant and the scatter of every lane into the flat coefficient buffer
after the prefill; one ``dwt_lift_program`` call on the planes' quadrant
pyramids in that buffer (``flat_lift_plan``: strided jobs); and the same
tail (steps 6-7, shared in ``_Program``).

The assembly plan (``PrecPlan`` .. ``AssemblyPlan``, ``build_plan``) is
copied verbatim from the reference module: numpy only, static per
codestream geometry. Samples wider than 16 bits raise NotImplementedError
here; ``Decoder`` negotiates the pixel format first, which raises the
reference's PatchWelcome for such streams before a program is built.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ffmpeg_ht_tpu_torch.codestream import markers as mk
from ffmpeg_ht_tpu_torch.ops import coef_cuda, dwt_cuda, mct_cuda
from ffmpeg_ht_tpu_torch.ops.coef_cuda import CoefLayout
from ffmpeg_ht_tpu_torch.ops.dwt import dwt_levels
from ffmpeg_ht_tpu_torch.ops.dwt_torch import dwt_poly_capable
from ffmpeg_ht_tpu_torch.ops.ht_refine import decode_refinement_scan
from ffmpeg_ht_tpu_torch.ops.ht_scan import (decode_cleanup_scan_dims,
                                             decode_cleanup_scan_sig)
from ffmpeg_ht_tpu_torch.ops.mct_cuda import ict_writeframe, rct_writeframe
from ffmpeg_ht_tpu_torch.ops.wirepack import pack_words
from ffmpeg_ht_tpu_torch.utils import trace


@dataclass(frozen=True)
class PrecPlan:
    l0: int          # absolute first lane (geometry ordinal)
    ch: int          # codeblock grid rows
    cw: int          # codeblock grid cols
    blk_h: int       # full block dims (last row/col may be smaller)
    blk_w: int
    ph: int          # precinct pixel dims
    pw: int
    x0: int          # position in the plane (quadrant coords)
    y0: int


@dataclass(frozen=True)
class BandPlan:
    rows: Tuple[Tuple[PrecPlan, ...], ...]   # precinct mosaic, row-major
    bh: int
    bw: int


@dataclass(frozen=True)
class PlanePlan:
    plane_idx: int
    ph: int
    pw: int
    ndec: int
    levels: Tuple                 # (ll, ((hl, lh, hh), ...)) BandPlans


@dataclass(frozen=True)
class AssemblyPlan:
    planes: Tuple[PlanePlan, ...]
    n_lanes: int
    bh: int                       # bucket raster dims (2*qh, 2*qw)
    bw: int


def build_plan(fg) -> Optional[AssemblyPlan]:
    """Static assembly plan from a FlatGeometry, or None if any precinct
    grid is irregular (unaligned band origin — v2 fallback)."""
    w = fg.w
    h = fg.h
    dest = fg.dest
    stride = fg.stride
    planes = fg.geom.planes

    # group precincts per (plane, rl, band)
    bands = {}
    for (l0, ch, cw, pidx, tileno, compno, rlno, bandno) in fg.prec_list:
        n = ch * cw
        if n == 0:
            continue
        colw = [int(w[l0 + j]) for j in range(cw)]
        rowh = [int(h[l0 + i * cw]) for i in range(ch)]
        # rectangular grid with uniform interior
        for i in range(ch):
            for j in range(cw):
                if int(w[l0 + i * cw + j]) != colw[j] \
                        or int(h[l0 + i * cw + j]) != rowh[i]:
                    return None
        if any(cv != colw[0] for cv in colw[:-1]) \
                or any(rv != rowh[0] for rv in rowh[:-1]):
            return None
        if colw[-1] > colw[0] or rowh[-1] > rowh[0]:
            return None
        poff, _, pstride = planes[pidx]
        rel = int(dest[l0]) - poff
        if int(stride[l0]) != pstride:
            return None
        y0, x0 = rel // pstride, rel % pstride
        # every cblk's dest must match its grid slot
        for i in range(ch):
            for j in range(cw):
                ex = x0 + sum(colw[:j])
                ey = y0 + sum(rowh[:i])
                if int(dest[l0 + i * cw + j]) - poff \
                        != ey * pstride + ex:
                    return None
        pp = PrecPlan(l0=int(l0), ch=ch, cw=cw, blk_h=rowh[0],
                      blk_w=colw[0], ph=sum(rowh), pw=sum(colw),
                      x0=x0, y0=y0)
        bands.setdefault((pidx, rlno, bandno), []).append(pp)

    def band_plan(key, exp_w, exp_h, exp_x0, exp_y0) -> Optional[BandPlan]:
        pps = bands.get(key, [])
        if not pps:
            if exp_w == 0 or exp_h == 0:
                return BandPlan(rows=(), bh=exp_h, bw=exp_w)
            return None
        rows = {}
        for pp in pps:
            rows.setdefault(pp.y0, []).append(pp)
        out_rows = []
        ys = sorted(rows.keys())
        cy = exp_y0
        for y in ys:
            row = sorted(rows[y], key=lambda p: p.x0)
            if y != cy:
                return None
            cx = exp_x0
            ph = row[0].ph
            for pp in row:
                if pp.x0 != cx or pp.ph != ph:
                    return None
                cx += pp.pw
            if cx - exp_x0 != exp_w:
                return None
            cy += ph
            out_rows.append(tuple(row))
        if cy - exp_y0 != exp_h:
            return None
        return BandPlan(rows=tuple(out_rows), bh=exp_h, bw=exp_w)

    def cdp2(v, k):
        return -((-v) >> k)

    plane_plans = []
    for pidx, (poff, ph, pw) in enumerate(planes):
        ndec = fg.geom.ndecs[pidx]
        border = fg.geom.borders[pidx]
        (x0b, x1b), (y0b, y1b) = border

        def lvl_dims(r, ndec=ndec, x0b=x0b, x1b=x1b, y0b=y0b, y1b=y1b):
            """Reslevel-r plane dims (r = ndec is the full plane)."""
            s = ndec - r
            return (cdp2(x1b, s) - cdp2(x0b, s),
                    cdp2(y1b, s) - cdp2(y0b, s))

        llw, llh = lvl_dims(0)
        ll = band_plan((pidx, 0, 0), llw, llh, 0, 0)
        if ll is None:
            return None
        lvls = []
        cw_, ch_ = llw, llh
        for r in range(1, ndec + 1):
            lw, lh = lvl_dims(r)
            hlw, hlh = lw - cw_, ch_
            lhw, lhh = cw_, lh - ch_
            hhw, hhh = lw - cw_, lh - ch_
            hl = band_plan((pidx, r, 0), hlw, hlh, cw_, 0)
            lhb = band_plan((pidx, r, 1), lhw, lhh, 0, ch_)
            hh = band_plan((pidx, r, 2), hhw, hhh, cw_, ch_)
            if hl is None or lhb is None or hh is None:
                return None
            lvls.append((hl, lhb, hh))
            cw_, ch_ = lw, lh
        if (cw_, ch_) != (pw, ph):
            return None
        plane_plans.append(PlanePlan(plane_idx=pidx, ph=ph, pw=pw,
                                     ndec=ndec, levels=(ll, tuple(lvls))))

    bw = 2 * (-(-int(fg.w.max()) // 2)) if fg.ncblks else 2
    bh = 2 * (-(-int(fg.h.max()) // 2)) if fg.ncblks else 2
    return AssemblyPlan(planes=tuple(plane_plans), n_lanes=fg.ncblks,
                        bh=bh, bw=bw)


def _compose_plane(ras, plane: PlanePlan, lane_off: int):
    """The quadrant pyramid of one plane from its band mosaics
    (assembly.py:224-236): the flat-DWT fallback's input, as the JAX
    program composes it (the tests hold the programs' band route against
    it and ``dwt_torch.dwt_decode_flat``)."""
    mosaic = coef_cuda.mosaic_band
    ll, lvls = plane.levels
    p = mosaic(ras, ll, lane_off)
    for (hl, lhb, hh) in lvls:
        top = torch.cat([p, mosaic(ras, hl, lane_off)], 1)
        bot = torch.cat([mosaic(ras, lhb, lane_off),
                         mosaic(ras, hh, lane_off)], 1)
        p = torch.cat([top, bot], 0)
    return p


@dataclass(frozen=True)
class FrameLayout:
    """Where a program writes each tile-component plane of a frame, and
    the frame that the host cuts out of its output.

    ``dests[i]`` is tile-component plane i's (dst, rs, cs, sh) in its
    frame (``ops/mct_cuda``: sample (r, c) at dst + r*rs + c*cs, shifted
    left by sh); frame f starts at f * ``frame_size`` of the output, and
    the ok flag follows the last frame. ``wide``: uint16 samples (held
    as int16), else uint8. ``zero``: some sample of a frame plane is
    written by no tile-component, so the output starts zeroed. ``planes``
    (offset, rows, columns) of each frame plane, ``fmt``, ``width`` and
    ``height`` make the ``DecodedFrame``; the program's own
    tile-component layout (``identity``) has none of them, and may be
    bit-packed into words (``wire_pack``)."""
    dests: Tuple[Tuple[int, int, int, int], ...]
    frame_size: int
    wide: bool
    zero: bool = False
    planes: Tuple[Tuple[int, int, int], ...] = ()
    fmt: object = None
    width: int = 0
    height: int = 0
    wire_pack: bool = False

    @classmethod
    def identity(cls, geom_key: Tuple,
                 wire_pack: bool = False) -> "FrameLayout":
        """The tile-component planes of geometry `geom_key` (a
        ``_Geometry.key()``) back to back, unshifted, in a frame of its
        `total` cbps-bit samples; with `wire_pack`, packed into words."""
        planes, cbps, total = geom_key[0], geom_key[5], geom_key[6]
        return cls(tuple((off, pw, 1, 0) for off, _ph, pw in planes),
                   total, cbps > 8, wire_pack=wire_pack)

    def replicate(self, frames: int) -> "FrameLayout":
        """The layout of `frames` frames taken as one (the v2 program's
        frame-replicated geometry)."""
        fs = self.frame_size
        return dataclasses.replace(
            self, frame_size=frames * fs,
            dests=tuple((f * fs + d, rs, cs, sh) for f in range(frames)
                        for d, rs, cs, sh in self.dests))


def _border(border):
    return [[border[0][0], border[0][1]], [border[1][0], border[1][1]]]


class _Program:
    """What the v3 and the v2 programs share: the geometry and the MCT /
    DC shift / clip / frame write tail, into `layout` (with its
    ``wire_pack``, the identity layout's 8 < cbps < 16 samples
    bit-packed into words)."""

    def __init__(self, geom_key: Tuple, frames: int, no_istep: bool,
                 layout: FrameLayout):
        (planes, borders, ndecs, mct_flags, tci, cbps, total,
         transform) = geom_key
        if cbps > 16:
            raise NotImplementedError(
                f"{cbps}-bit samples do not fit the uint16 packed output")
        if layout.wire_pack and (not 8 < cbps < 16
                                 or layout.fmt is not None):
            raise ValueError("wire pack takes 9..15-bit samples in the "
                             f"identity layout, not {cbps}")
        if cbps > 8 and not layout.wide:
            raise ValueError(f"{cbps}-bit samples do not fit uint8")
        self.wire_pack, self.frame_layout = layout.wire_pack, layout
        self.planes, self.borders, self.ndecs = planes, borders, ndecs
        self.mct_flags, self.tci = mct_flags, tci
        self.cbps, self.total, self.transform = cbps, total, transform
        self.frames, self.no_istep = frames, no_istep
        self.out_dtype = torch.int16 if layout.wide else torch.uint8

    def _mct(self, tileno: int) -> bool:
        """Whether tile `tileno`'s first three planes take RCT / ICT: its
        MCT flag and three planes of one (h, w)."""
        idxs = self.tci[tileno]
        if not self.mct_flags[tileno] or len(idxs) < 3:
            return False
        shapes = [tuple(self.planes[i][1:]) for i in idxs[:3]]
        return shapes[0] == shapes[1] == shapes[2]

    def kernel_launches(self):
        """{counter: launches} one call of the program adds on the card:
        its coefficient stage (``coef_launches``), ``dwt_small`` once
        when a plane has a level under 8x8, ``dwt_lift`` once a level,
        ``plane_writeframe`` once each ``mct_cuda.MAX_PLANES`` planes
        without MCT (none when every plane has MCT)."""
        counts = {"coef_mosaic": 0, "bucket_scatter": 0,
                  "dwt_lift": self.lift.lift_launches,
                  "dwt_small": self.lift.small_launches,
                  "plane_writeframe": mct_cuda.plane_writeframe_launches(
                      sum(1 for _f, i in self._writes()
                          if self.planes[i][1] * self.planes[i][2]))}
        counts[self.COEF_STAGE] = self.coef_launches()
        return counts

    def coef_launches(self) -> int:
        """Launches of the coefficient stage a call counts:
        ``coef_mosaic`` once."""
        return 1

    def _writes(self):
        """(frame, plane index) of every plane that no MCT takes, of every
        frame, in the order of the pack's one ``plane_writeframe``
        call."""
        return [(f, i) for tileno, idxs in enumerate(self.tci)
                for f in range(self.frames)
                for i in (idxs[3:] if self._mct(tileno) else idxs)]

    def _dest(self, frame: int, plane: int):
        """Tile-component plane `plane`'s dest in frame `frame` of the
        output."""
        dst, rs, cs, sh = self.frame_layout.dests[plane]
        return dst + frame * self.frame_layout.frame_size, rs, cs, sh

    def writes(self, outs):
        """(planes, their dests in the output) of ``_writes``."""
        n = len(self.planes)
        return ([outs[f * n + i] for f, i in self._writes()],
                [self._dest(f, i) for f, i in self._writes()])

    def pack(self, outs, ok):
        """Stages 6-7: MCT / DC shift / clip, each sample written where
        the layout puts it: tile-component plane i of frame f at its dest,
        f * frame_size on. The ICT of a tile runs for every frame in one
        call, and every plane without MCT of every frame goes through one
        ``plane_writeframe`` call. With ``wire_pack`` the buffer, flag
        included, is packed into words (one launch)."""
        fs, F = self.frame_layout.frame_size, self.frames
        alloc = torch.zeros if self.frame_layout.zero else torch.empty
        packed = alloc(F * fs + 1, dtype=self.out_dtype, device=ok.device)
        nplanes = len(self.planes)
        for tileno, idxs in enumerate(self.tci):
            if not self._mct(tileno):
                continue
            ys = [tuple(outs[f * nplanes + i].contiguous()
                        for i in idxs[:3]) for f in range(F)]
            if self.transform == mk.DWT53:
                for f, y in enumerate(ys):
                    rct_writeframe(*y, self.cbps, out=packed,
                                   dests=[self._dest(f, i)
                                          for i in idxs[:3]])
            else:
                ict_writeframe(ys, self.cbps, self.transform, out=packed,
                               frame_stride=fs,
                               dests=[self._dest(0, i) for i in idxs[:3]])
        planes, dests = self.writes(outs)
        if planes:
            mct_cuda.plane_writeframe(planes, self.cbps, packed, dests)
        # ok flag: inert and pad lanes pass trivially
        packed[F * fs:].copy_(ok.all().reshape(1))
        if self.wire_pack:
            return pack_words(packed, self.cbps)
        return packed


class V3Program(_Program):
    """The fused decode program for one geometry and frame count.

    ``prog(msw, melw, vlcw, pLSB, maxbp, ms_lim, mel_lim, qws, qhs, magb,
    istep, scale97, fscale, pf_idx, pf_val) -> packed`` with the argument
    names and layouts of the JAX program (models/fastpath.finish_v3);
    `packed` is bit-packed words with its layout's ``wire_pack``.
    Arrays carry frames * n_pad lanes, frame-major; pf_idx indexes the
    frames' flat lane rasters and its pads point one past their end.
    """

    COEF_STAGE = "coef_mosaic"

    def __init__(self, plan: AssemblyPlan, geom_key: Tuple, qw: int,
                 qh: int, ms_class: int, n_pad: int, frames: int,
                 layout: FrameLayout, no_istep: bool = False):
        super().__init__(geom_key, frames, no_istep, layout)
        # whether every level of every plane is at least 8x8 (the JAX
        # program's band-direct test, assembly.py:283-286); else the JAX
        # program takes the flat fallback, and here the small levels are
        # small jobs of the same LiftPlan
        self.band_direct = all(
            nd == 0 or dwt_poly_capable(_border(b), nd)
            for b, nd in zip(self.borders, self.ndecs))
        self.plan = plan
        self.qw, self.qh, self.ms_class = qw, qh, ms_class
        self.n_pad = n_pad
        self._band_schedule()

    def _band_schedule(self):
        """The band buffer's layout (every band of every plane of every
        frame: LL, then HL, LH, HH level by level); per (frame, plane),
        the indices of its LL and of each level's bands and the levels'
        origin parities; and the inverse DWT's job table over them."""
        bands, self._ll, self._lvls, self._mods = [], [], [], []
        for f in range(self.frames):
            for plane_p, border, ndec in zip(self.plan.planes, self.borders,
                                             self.ndecs):
                ll, lvls = plane_p.levels
                self._ll.append(len(bands))
                bands.append((ll, f * self.n_pad))
                idx = []
                for lvl in lvls:
                    idx.append(tuple(range(len(bands), len(bands) + 3)))
                    bands.extend((bb, f * self.n_pad) for bb in lvl)
                self._lvls.append(idx)
                self._mods.append(dwt_levels(_border(border), ndec)[1])
        self.layout = CoefLayout(bands, self.frames * self.n_pad,
                                 self.plan.bh, self.plan.bw)
        self.levels = max(map(len, self._lvls))
        self.lift = dwt_cuda.LiftPlan(
            self.layout.offsets, self.layout.shapes,
            list(zip(self._ll, self._lvls, self._mods)), self.transform)

    def level_jobs(self, lev: int, outs, bands):
        """(the planes that have level `lev`, their ``dwt_lift`` jobs),
        from every plane's current LL `outs` and the band views `bands`;
        the integer 9/7's final shift rides on each plane's last level
        (a band-direct program's levels)."""
        todo = [i for i, idx in enumerate(self._lvls) if lev < len(idx)]
        return todo, [(outs[i], *(bands[b] for b in self._lvls[i][lev]),
                       *self._mods[i][lev],
                       self.transform == mk.DWT97_INT
                       and lev == len(self._lvls[i]) - 1) for i in todo]

    @trace.timed("launch")
    def __call__(self, **args):
        return self.pack(*self.decode_planes(**args))

    def decode_planes(self, msw, melw, vlcw, pLSB, maxbp, ms_lim, mel_lim,
                      qws, qhs, magb, istep, scale97, fscale, pf_idx,
                      pf_val):
        """Stages 1-5: (per-frame tile-component planes after the inverse
        DWT, in geometry order; per-lane ok). Every band of the F frames
        in one ``coef_mosaic`` call, then every DWT level of every plane
        in one ``dwt_lift_program`` call (the integer 9/7's final shift
        on each plane's last level)."""
        mu, _sig, ok = decode_cleanup_scan_dims(
            msw, melw, vlcw, pLSB, maxbp, ms_lim, mel_lim, qws, qhs,
            self.qw, self.qh, self.ms_class)
        buf = coef_cuda.coef_mosaic(
            mu, magb, istep, scale97, fscale, pf_idx, pf_val, self.layout,
            self.transform, self.no_istep)
        scratch = dwt_cuda.dwt_lift_program(self.lift, buf)
        return [self.layout.view(buf, ll) if last is None
                else self.lift.view(scratch, last)
                for ll, last in zip(self._ll, self.lift.last)], ok


def flat_lift_plan(planes, borders, ndecs, transform: int, size: int):
    """The ``LiftPlan`` of every tile-component plane's quadrant pyramid
    in one flat buffer of `size` samples: plane i at ``planes[i] = (off,
    ph, pw)``, row-major. Level l of a plane covers its top-left (lv, lh)
    corner, split at (nEv, nE) into LL (the previous level's output, or
    the plane's corner on its first level), HL, LH and HH, every band at
    the plane's row stride pw."""
    offs, shapes, specs = [], [], []

    def band(o, r, c):
        offs.append(o)
        shapes.append((r, c))
        return len(offs) - 1

    for (off, _ph, pw), border, ndec in zip(planes, borders, ndecs):
        linelen, mods = dwt_levels(_border(border), ndec)
        ll, lvls = None, []
        for (lh, lv), (mh, mv) in zip(linelen, mods):
            nE, nEv = (lh + 1 - mh) // 2, (lv + 1 - mv) // 2
            if ll is None:
                ll = band(off, nEv, nE)
            lvls.append((band(off + nE, nEv, lh - nE),
                         band(off + nEv * pw, lv - nEv, nE),
                         band(off + nEv * pw + nE, lv - nEv, lh - nE)))
        specs.append((band(off, 0, 0) if ll is None else ll, lvls,
                       [tuple(m) for m in mods]))
    strides = [pw for (_o, _ph, pw), (_l, lvls, _m) in zip(planes, specs)
               for _b in range(1 + 3 * len(lvls))]
    return dwt_cuda.LiftPlan(offs, shapes, specs, transform,
                             band_strides=strides, buffer_size=size)


class BucketProgram(_Program):
    """The v2 decode program for one geometry and its buckets (counterpart
    of ``_entropy_stage`` plus ``_compiled_assembly``, decoder.py:426-606).

    ``prog(pf_idx, pf_val, bucket_args) -> packed`` (bit-packed words
    with its layout's ``wire_pack``); `shapes` holds a
    ``(qw, qh, w, h, ms_class, refined)`` tuple per bucket and
    `bucket_args` that bucket's lane arrays (models/fastpath.
    pack_bucket) on the device, ``nreal``
    an int. Per bucket: the HT cleanup, plus SigProp / MagRef on refined
    buckets (ops/ht_refine). Then one ``bucket_scatter`` call dequantizes
    every lane into one flat buffer of ``total + 1`` samples after the
    sparse prefill of the host-decoded lanes (pad lanes, samples outside a
    codeblock and the prefill's pad go to the trailing trash slot); one
    ``dwt_lift_program`` call runs the inverse DWT of every tile-component
    plane from that buffer (its quadrant pyramid, a ``flat_lift_plan``
    built once); the v3 program's MCT / DC shift / clip / pack tail. A
    batch of F frames is one program over the frame-replicated
    geometry."""

    COEF_STAGE = "bucket_scatter"

    def __init__(self, shapes, geom_key: Tuple, layout: FrameLayout):
        super().__init__(geom_key, frames=1, no_istep=False, layout=layout)
        self.shapes = tuple(shapes)
        self.dims = [(w, h) for _qw, _qh, w, h, _m, _r in self.shapes]
        self.scatter = coef_cuda.ScatterPlan(
            [(2 * qh, 2 * qw) for qw, qh, *_r in self.shapes], self.dims)
        self.lift = flat_lift_plan(self.planes, self.borders, self.ndecs,
                                   self.transform, self.total + 1)
        self._lane_dims = {}    # the cleanup's (qws, qhs), ht_scan's cache

    def coef_launches(self) -> int:
        """``bucket_scatter`` once each ``coef_cuda.MAX_BUCKETS`` buckets
        (every bucket has lanes: its pads at least)."""
        return coef_cuda.bucket_scatter_launches(len(self.shapes))

    @trace.timed("launch")
    def __call__(self, pf_idx, pf_val, bucket_args):
        return self.pack(*self.decode_planes(pf_idx, pf_val, bucket_args))

    def entropy(self, bucket_args):
        """(mu, ok) of every bucket (``_entropy_stage``)."""
        mus, oks = [], []
        for (qw, qh, w, h, msc, refined), a in zip(self.shapes, bucket_args):
            mu, sig, ok = decode_cleanup_scan_sig(
                a["msw"], a["melw"], a["vlcw"], a["pLSB"], a["maxbp"],
                a["ms_lim"], a["mel_lim"], qw, qh, msc, a["nreal"],
                dims_cache=self._lane_dims)
            if refined:
                mu = decode_refinement_scan(
                    mu, sig, a["spw"], a["mrw"], a["pLSB"], a["has_sp"],
                    a["has_mr"], a["causal"], qw, qh, w, h)
            mus.append(mu)
            oks.append(ok)
        return mus, oks

    def decode_planes(self, pf_idx, pf_val, bucket_args):
        """(tile-component planes after the inverse DWT, in geometry order;
        the lanes' ok, pad lanes true: they are inert)."""
        mus, oks = self.entropy(bucket_args)
        flat = coef_cuda.bucket_scatter(
            mus, self.dims, bucket_args, pf_idx, pf_val, self.total,
            self.transform, self.no_istep, plan=self.scatter)
        scratch = dwt_cuda.dwt_lift_program(self.lift, flat)
        outs = [flat[off:off + ph * pw].view(ph, pw) if last is None
                else self.lift.view(scratch, last)
                for (off, ph, pw), last in zip(self.planes, self.lift.last)]
        ok = torch.cat(oks) if oks else torch.ones(
            1, dtype=torch.bool, device=flat.device)
        return outs, ok
