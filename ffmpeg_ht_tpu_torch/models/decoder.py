"""HTJ2K decoder on a torch device (counterpart of
``ffmpeg_ht_tpu.models.decoder.Decoder``).

The host tier is the port's own copy of the reference's: codestream
parse, the flat fast lane (native T2 parse, lane building, assembly
plan), the object path's bucketing (``_build_batch`` below, copied from
the reference apart from the imports and its ``_Bucket``, which keeps
each lane's bytes for ``fastpath.pack_bucket``), the host oracle and the
frame writer. Two device programs, both for HTONLY streams with any of
the three transforms (reversible 5/3, integer 9/7 with ``bitexact=True``,
float 9/7 with ``bitexact=False``):

- ``models/assembly.V3Program``, the v3 fused fast lane: one cleanup
  launch over every codeblock, band mosaics, the inverse DWT of every
  level;
- ``models/assembly.BucketProgram`` (``bucket_program``, built once per
  bucket layout and geometry), the v2 bucketed path: codeblocks
  bucketed by shape and stream length, the cleanup per bucket plus
  SigProp / MagRef on refined buckets, a scatter into a flat buffer, the
  inverse DWT of its quadrant pyramids.

Routing follows the reference ``Decoder``:

- streams the reference hands to the host oracle (legacy MQ codeblocks,
  ROI, unsupported transforms, ...) go to the same
  ``host_decoder.decode_frame``;
- fast-profile streams take the flat fast lane: the V3Program when the
  geometry has an assembly plan and the frame has no refinement lanes and
  no lane with maxbp > 25, else the BucketProgram on the lanes that
  ``fastpath.build_bucket_args`` / ``finish_buckets`` build;
- everything else on the device (vertically stripe-causal codeblocks,
  ``max_layers``, a failed native parse) takes the object path: T2 into
  codeblock objects, ``_build_batch``, the BucketProgram.

In both v2 routes, codeblocks under ``_HOST_AREA`` samples and those
with more than 25 magnitude bitplanes decode on the host oracle and
reach the device as a sparse prefill. ``decode_batch`` runs same-geometry
frames as one program (either kind); ``bench_resident`` times the
V3Program only, at full resolution, as in the reference.

Both programs write each frame in the negotiated pixel format's layout
and precision (``frame_layout``: R, G, B interleaved in ``rgb48le`` and
shifted to 16 bits, every tile at its place), worked out once where the
program is chosen (``Decoder._layout``); it joins the key of the program
caches and travels with the fetched output, and the host copies each
plane of each frame out of that buffer once (``_split_frames``). ``wire_pack=True`` bit-packs
9..15-bit output on the device into words (ops/wirepack, the kernel
``csrc/wire_pack.cu``) on both programs, in the tile-component layout,
and the host unpacks it and writes the frame (``_assemble_frame``); off
by default, as in the reference. The pixel format is negotiated before
a program is built, so a stream that no format fits raises the
reference's PatchWelcome on every route.
``FFMPEG_HT_TPU_V3=0`` turns the V3Program off in ``decode*`` (the
reference's switch), so fast-profile streams take the BucketProgram.
``decode_frame_cuda`` is the one-shot wrapper.

``decode_batch(streams, devices=[...])`` shards the frame axis of a
same-geometry v3 batch over the listed devices (the reference's
``mesh=``, decoder.py:712-739,804-936): the frames are padded to a
multiple of D = len(devices) by repeating the last one, each device runs
the V3Program of its F/D frames with its own lane arguments and prefill,
and the pad frames are dropped. A batch that cannot shard raises
``UnshardableBatch`` with ``require_shard=True``, else it logs the
reason and decodes on one device.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ffmpeg_ht_tpu_torch.codestream import markers as mk
from ffmpeg_ht_tpu_torch.codestream.geometry import Tile, ceildiv, init_tile
from ffmpeg_ht_tpu_torch.codestream.parser import parse_codestream
from ffmpeg_ht_tpu_torch.codestream.t2 import decode_tile_packets
from ffmpeg_ht_tpu_torch.models import assembly as ASM
from ffmpeg_ht_tpu_torch.models import fastpath as FP
from ffmpeg_ht_tpu_torch.models import host_decoder
from ffmpeg_ht_tpu_torch.models import pixfmt as pf
from ffmpeg_ht_tpu_torch.models.assembly import (BucketProgram, FrameLayout,
                                                 V3Program)
from ffmpeg_ht_tpu_torch.models.fastpath import (_Geometry, finish_v3_numpy,
                                                 to_torch)
from ffmpeg_ht_tpu_torch.models.host_decoder import DecodedFrame
from ffmpeg_ht_tpu_torch.ops.wirepack import unpack_words
from ffmpeg_ht_tpu_torch.utils import trace
from ffmpeg_ht_tpu_torch.utils.device import resolve_device
from ffmpeg_ht_tpu_torch.utils.errors import InvalidData, UnshardableBatch
from ffmpeg_ht_tpu_torch.utils.log import logger

_LANE_PAD = 8          # lane count rounded up to a multiple of this
_HOST_AREA = 256       # codeblocks smaller than this decode on the host
                       # oracle (edge slivers and low-resolution bands),
                       # as in the reference
_MAX_GEOMS = 32
_DEVICE_TRANSFORMS = (mk.DWT53, mk.DWT97_INT, mk.DWT97)


def _supported_on_device(hdr, tiles: List[Tile]) -> bool:
    """Device path covers HTONLY streams without ROI; all three transforms
    (5/3 reversible, bitexact integer 9/7, float 9/7), uniform across the
    frame's tile-components (one flat-buffer dtype per launch)."""
    transform = tiles[0].codsty[0].transform if tiles else mk.DWT53
    for tile in tiles:
        for compno, comp in enumerate(tile.comp):
            codsty = tile.codsty[compno]
            if codsty.transform not in _DEVICE_TRANSFORMS \
                    or codsty.transform != transform:
                return False
            if comp.roi_shift:
                return False
            qntsty = tile.qntsty[compno]
            for sb in range(codsty.nreslevels2decode * 3 - 2):
                if qntsty.expn[sb] + qntsty.nguardbits - 1 >= 31:
                    return False  # host raises PatchWelcome (HT M_b >= 31)
            if not (codsty.cblk_style & mk.CTSY_HTJ2K_F):
                return False
            if (codsty.log2_cblk_width > 6 or codsty.log2_cblk_height > 6):
                return False  # kernel raster capacity is 64x64
            for rl in comp.reslevel:
                for band in rl.band:
                    for prec in band.prec:
                        for cblk in prec.cblk:
                            if cblk.npasses == 0:
                                continue
                            if not (cblk.modes & mk.CTSY_HTJ2K_F):
                                return False
    return True


@dataclass
class _Bucket:
    """One bucket of the object path, as ``fastpath.pack_bucket`` reads
    it: each lane's cleanup bytes (modDcup applied) and Dref bytes, one
    lane after another in `body`, and its columns."""
    w: int
    h: int
    body: bytearray = field(default_factory=bytearray)
    off: List[int] = field(default_factory=list)     # lane's start in body
    lcup: List[int] = field(default_factory=list)
    lref: List[int] = field(default_factory=list)    # 0 unless refined
    zblk: List[int] = field(default_factory=list)    # 1..3 HT passes
    pcup: List[int] = field(default_factory=list)
    zbp: List[int] = field(default_factory=list)     # zbp_eff
    magb: List[int] = field(default_factory=list)
    istep: List[int] = field(default_factory=list)
    scale97: List[int] = field(default_factory=list)   # int97 dequant scale
    fscale: List[float] = field(default_factory=list)  # float dequant scale
    dest: List[int] = field(default_factory=list)    # flat index of (y0,x0)
    stride: List[int] = field(default_factory=list)  # plane row stride
    causal: List[int] = field(default_factory=list)  # CBLK_VSC per lane

    ROWS = ("lcup", "lref", "zblk")      # with `off`: the lanes' rows
    COLS = ("pcup", "zbp", "magb", "istep", "scale97", "fscale", "dest",
            "stride", "causal")

    def extend(self, b: "_Bucket", dest_shift: int) -> None:
        """Append `b`'s lanes, their dests shifted by `dest_shift`."""
        self.off.extend(o + len(self.body) for o in b.off)
        self.body += b.body
        self.dest.extend(d + dest_shift for d in b.dest)
        for fld in self.ROWS + self.COLS:
            if fld != "dest":
                getattr(self, fld).extend(getattr(b, fld))

    def pack(self):
        """(shape, argument dict) of the bucket (``fastpath.pack_bucket``;
        its rows already carry modDcup)."""
        return FP.pack_bucket(
            (self.w, self.h),
            [(self.body, self.off, *(getattr(self, k) for k in self.ROWS))],
            {k: getattr(self, k) for k in self.COLS}, moddcup=False)


def _build_batch(hdr, tiles: List[Tile]):
    """Walk the T2 result into shape buckets + a flat-plane geometry."""
    planes = []
    borders = []
    ndecs = []
    tile_comp_index = []
    offset = 0
    for tile in tiles:
        idxs = []
        for compno, comp in enumerate(tile.comp):
            cw = comp.coord[0][1] - comp.coord[0][0]
            ch = comp.coord[1][1] - comp.coord[1][0]
            idxs.append(len(planes))
            planes.append((offset, ch, cw))
            borders.append(((comp.coord[0][0], comp.coord[0][1]),
                            (comp.coord[1][0], comp.coord[1][1])))
            ndecs.append(tile.codsty[compno].nreslevels2decode - 1)
            offset += ch * cw
        tile_comp_index.append(idxs)
    total = offset

    transform = tiles[0].codsty[0].transform if tiles else mk.DWT53
    buckets: Dict[Tuple[int, int], _Bucket] = {}
    prefill = np.zeros(total + 1,
                       np.float32 if transform == mk.DWT97 else np.int32)
    for tileno, tile in enumerate(tiles):
        for compno, comp in enumerate(tile.comp):
            qntsty = tile.qntsty[compno]
            poff, _, pstride = (planes[tile_comp_index[tileno][compno]][0],
                                0, planes[tile_comp_index[tileno][compno]][2])
            subbandno = 0
            # lowres: reslevels >= nreslevels2decode were parsed (their
            # packets occupy the stream) but decode no coefficients —
            # their dests lie outside the reduced plane
            # (jpeg2000dec.c:509-520)
            n2d = tile.codsty[compno].nreslevels2decode
            for rl in comp.reslevel[:n2d]:
                for bandno, band in enumerate(rl.band):
                    magb = qntsty.expn[subbandno] + qntsty.nguardbits - 1
                    subbandno += 1
                    if (band.coord[0][0] >= band.coord[0][1]
                            or band.coord[1][0] >= band.coord[1][1]):
                        continue
                    for prec in band.prec:
                        for cblk in prec.cblk:
                            w, h = cblk.width, cblk.height
                            if w <= 0 or h <= 0 or cblk.npasses == 0:
                                continue
                            lcup = cblk.pass_lengths[0]
                            if lcup < 2:
                                # error parity with the host oracle
                                # (ht_dec.py) and the reference
                                # (jpeg2000htdec.c:1252-1256): a frame must
                                # never silently decode to different pixels
                                # depending on which path ran
                                raise InvalidData("cleanup pass length < 2")
                            x = cblk.coord[0][0] - band.coord[0][0]
                            y = cblk.coord[1][0] - band.coord[1][0]
                            dest = poff + y * pstride + x
                            num_rempass = cblk.npasses % 3
                            num_plhd = (cblk.npasses - num_rempass
                                        if num_rempass
                                        else cblk.npasses - 3)
                            z_blk = cblk.npasses - num_plhd
                            # placeholder passes shift the bitplane:
                            # S_blk = p0 + zbp (ht_dec.py:611,627)
                            zbp_eff = cblk.zbp + num_plhd // 3
                            causal = bool(cblk.modes & mk.CBLK_VSC)
                            if w * h < _HOST_AREA \
                                    or zbp_eff + 1 > 25:
                                # tiny edge slivers and extreme-bitplane
                                # blocks (the kernel's MagSgn reads cap
                                # at 25 bits/sample):
                                # scalar host decode into the prefill
                                from ffmpeg_ht_tpu_torch.ops import dequant as dq
                                from ffmpeg_ht_tpu_torch.ops import ht_dec
                                trace.count("oracle_lanes")
                                with trace.span("oracle"):
                                    t1 = ht_dec.decode_htj2k(
                                        bytes(cblk.data), cblk.npasses,
                                        cblk.zbp, cblk.pass_lengths, w, h,
                                        magb, 0, int(causal))
                                    if transform == mk.DWT97:
                                        blk = dq.dequant_float(
                                            t1, band.f_stepsize, magb)
                                    elif transform == mk.DWT97_INT:
                                        blk = dq.dequant_int_97(
                                            t1, band.f_stepsize, magb)
                                    else:
                                        blk = dq.dequant_int(
                                            t1, band.i_stepsize, magb)
                                    for yy in range(h):
                                        s = dest + yy * pstride
                                        prefill[s:s + w] = blk[yy]
                                continue
                            buf = bytearray(cblk.data[:lcup])
                            if len(buf) < lcup:
                                buf.extend(b"\x00" * (lcup - len(buf)))
                            scup = ((buf[lcup - 1] << 4)
                                    + (buf[lcup - 2] & 0x0F))
                            if scup < 2 or scup > lcup or scup > 4079:
                                # parity with ht_dec.py / the reference
                                # (jpeg2000htdec.c:1265-1273)
                                raise InvalidData(f"invalid Scup {scup}")
                            buf[lcup - 1] = 0xFF
                            buf[lcup - 2] |= 0x0F
                            zbp = zbp_eff
                            # bucket by shape AND a pow2 stream-length
                            # class: lanes of similar length pack
                            # together, keeping the (N, W) upload close
                            # to the real content size
                            wc = 16
                            need = (8 * lcup + 96) // 32
                            while wc < need:
                                wc *= 2
                            key = (w, h, wc)
                            b = buckets.setdefault(key, _Bucket(w, h))
                            lref = (cblk.pass_lengths[1] if z_blk > 1
                                    else 0)
                            dref = bytes(cblk.data[lcup:lcup + lref])
                            b.off.append(len(b.body))
                            # a truncated Dref segment reads as zeros
                            b.body += buf + dref + bytes(lref - len(dref))
                            b.lcup.append(lcup)
                            b.lref.append(lref)
                            b.zblk.append(z_blk)
                            b.pcup.append(lcup - scup)
                            b.zbp.append(zbp)
                            b.magb.append(magb)
                            b.istep.append(band.i_stepsize)
                            from ffmpeg_ht_tpu_torch.ops.dequant import int97_scale
                            b.scale97.append(
                                int97_scale(band.f_stepsize, magb)
                                if transform == mk.DWT97_INT else 0)
                            b.fscale.append(float(
                                np.float32(band.f_stepsize)
                                / np.float32(1 << (31 - magb)))
                                if transform == mk.DWT97 else 0.0)
                            b.dest.append(dest)
                            b.stride.append(pstride)
                            b.causal.append(int(causal))

    geom = _Geometry(planes=planes, borders=tuple(borders),
                     ndecs=tuple(ndecs),
                     mct=tuple(bool(t.codsty[0].mct) for t in tiles),
                     tile_comp_index=tile_comp_index,
                     cbps=hdr.siz.components[0].depth, total=total,
                     transform=transform)
    return geom, buckets, prefill


def _replicate_geometry(g0: _Geometry, F: int) -> _Geometry:
    """Frame-replicated geometry: F frames side by side in the flat
    buffer (decode_batch lane merging)."""
    planes = []
    borders = []
    ndecs = []
    mct = []
    tci = []
    for f in range(F):
        pbase = len(planes)
        for (off, ph, pw) in g0.planes:
            planes.append((off + f * g0.total, ph, pw))
        borders.extend(g0.borders)
        ndecs.extend(g0.ndecs)
        mct.extend(g0.mct)
        for idxs in g0.tile_comp_index:
            tci.append(tuple(i + pbase for i in idxs))
    return _Geometry(planes=planes, borders=tuple(borders),
                     ndecs=tuple(ndecs), mct=tuple(mct),
                     tile_comp_index=[list(t) for t in tci],
                     cbps=g0.cbps, total=F * g0.total,
                     transform=g0.transform)


def _pad(n, q):
    return ((n + q - 1) // q) * q


def _ms_class(frames):
    """The MagSgn budget class that bounds every device lane's maxbp in
    ``build_v3_frame`` columns `frames`, or None when one exceeds 25."""
    mb = 1
    for fc in frames:
        devl = fc["qws"] > 0
        if devl.any():
            mb = max(mb, int(fc["maxbp"][devl].max()))
    return next((c for c in (8, 12, 16, 20, 25) if mb <= c), None)


def _pow2(n: int, lo: int) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


@functools.lru_cache(maxsize=64)
def bucket_program(shapes: Tuple, geom_key: Tuple,
                   layout: FrameLayout) -> BucketProgram:
    """The BucketProgram of one bucket layout, geometry and frame layout,
    built once (its DWT job table with it), as the JAX package caches
    ``_compiled_assembly`` (decoder.py:460)."""
    with trace.span("build"):
        trace.count("builds")
        return BucketProgram(shapes, geom_key, layout)


def _cdef(hdr) -> List[int]:
    """The channel definitions write_frame uses, defaults filled in
    (jpeg2000dec.c:2883-2892)."""
    siz = hdr.siz
    cdef = hdr.cdef if hdr.cdef else [-1] * 4
    if any(c < 0 for c in cdef[:siz.ncomponents]):
        cdef = [i + 1 for i in range(4)]
        if siz.ncomponents % 2 == 0:
            cdef[siz.ncomponents - 1] = 0
    return cdef


def frame_layout(hdrs, geom: _Geometry) -> FrameLayout:
    """The ``FrameLayout`` that frames of headers `hdrs` on geometry
    `geom` share: each tile-component plane where write_frame puts it in
    the negotiated pixel format (``_write_frame_prescaled``), shifted to
    the output precision. Where the headers' layouts differ, or where
    write_frame's placement is not one dest a plane (two components into
    one place, a plane outside its frame plane, a shift past the sample
    type), the tile-component planes (``FrameLayout.identity``), which
    ``_assemble_frame`` writes into each frame by its own header."""
    layouts = set()
    for hdr in hdrs:
        siz = hdr.siz
        fmt = pf.negotiate(siz, hdr.colour_space, siz.rsiz)
        layouts.add(_frame_layout(
            fmt, pf.output_precision(fmt, siz.precision),
            host_decoder._frame_dims(hdr),
            tuple(_cdef(hdr)[:siz.ncomponents]),
            tuple((c.depth, c.dx, c.dy) for c in siz.components),
            (siz.x0, siz.y0), tuple(geom.planes), tuple(geom.borders),
            tuple(map(tuple, geom.tile_comp_index)), geom.cbps))
    layout = layouts.pop() if len(layouts) == 1 else None
    return layout or FrameLayout.identity(geom.key())


@functools.lru_cache(maxsize=64)
def _frame_layout(fmt, precision, dims, cdef, comps, origin, planes,
                  borders, tci, cbps) -> Optional[FrameLayout]:
    """``frame_layout`` of one header (its fields as arguments)."""
    dimx, dimy = dims
    shapes = pf.frame_shapes(fmt, dimx, dimy)
    offsets = np.cumsum([0] + [h * w for h, w in shapes]).tolist()
    bits = 8 * fmt.bytes_per_sample
    nc = fmt.nb_components
    dests = [None] * len(planes)
    owner, area = {}, {}        # (frame plane, channel) -> comp, samples
    for idxs in tci:
        for compno, i in enumerate(idxs):
            depth, dx, dy = comps[compno]
            sh = precision - depth
            ox, oy = ceildiv(origin[0], dx), ceildiv(origin[1], dy)
            (x0, x1), (y0, y1) = borders[i]
            x0, x1, y0, y1 = x0 - ox, x1 - ox, y0 - oy, y1 - oy
            if fmt.planar:
                p, ch, cs = (cdef[compno] - 1 if cdef[compno]
                             else nc - 1), 0, 1
            else:
                p, ch, cs = 0, compno, nc
            if not (0 <= p < len(shapes) and ch < cs and sh >= 0
                    and cbps + sh <= bits):
                return None
            h, w = shapes[p]
            if x1 > x0 and y1 > y0:
                if x0 < 0 or y0 < 0 or y1 > h or x1 * cs > w:
                    return None
                area[p, ch] = area.get((p, ch), 0) + (x1 - x0) * (y1 - y0)
                if owner.setdefault((p, ch), compno) != compno:
                    return None
            dests[i] = (offsets[p] + max(y0, 0) * w + max(x0, 0) * cs + ch,
                        w, cs, sh)
    zero = any(area.get((p, ch), 0) != h * (w // (1 if fmt.planar else nc))
               for p, (h, w) in enumerate(shapes)
               for ch in range(1 if fmt.planar else nc))
    return FrameLayout(tuple(dests), offsets[-1], bits == 16, zero,
                       tuple((o, h, w) for o, (h, w) in zip(offsets,
                                                            shapes)),
                       fmt, dimx, dimy)


class Decoder:
    """HTJ2K decoder whose device programs run on `device`.

    `device` is required to exist: "cuda" without a usable card raises,
    and nothing falls back to the CPU. decode(data) -> DecodedFrame.
    `bitexact` picks the irreversible path as in the reference
    ``Decoder(bitexact=...)``: True decodes 9/7 streams with the integer
    9/7 (byte-identical to ``ffmpeg -flags +bitexact``), False with the
    float 9/7 (within 1 LSB). The parse records the choice in each
    codestream's transform, which the geometry cache key holds.
    `reduction_factor` decodes at 1 / 2**r resolution (``-lowres``) and
    `max_layers` keeps the first quality layers only (0: all), as the
    reference's options do. `wire_pack` bit-packs 9..15-bit output on the
    device so that the fetch moves depth/16 of the uint16 bytes, at the
    cost of an unpack on the host (decoder.py:616-642); off by default,
    as in the reference: a card on the host's PCIe fetches fast enough
    that the unpack only adds host work.
    """

    def __init__(self, device="cuda", bitexact: bool = True,
                 reduction_factor: int = 0, max_layers: int = 0,
                 wire_pack: bool = False):
        self.device = resolve_device(device)
        self.bitexact = bitexact
        self.reduction_factor = reduction_factor
        self.max_layers = max_layers
        self.wire_pack = wire_pack
        self._geoms = {}        # geometry fingerprint -> FlatGeometry
        self.v3_frames = 0      # frames decoded by the V3Program
        self.v2_frames = 0      # frames decoded by the BucketProgram
        self.host_frames = 0    # frames routed to the host oracle

    def _wp(self, cbps: int) -> bool:
        return self.wire_pack and 8 < cbps < 16

    def _layout(self, hdrs, geom: _Geometry) -> FrameLayout:
        """The ``FrameLayout`` a program writes frames `hdrs` of geometry
        `geom` in, worked out once where the program is chosen and handed
        to ``_split_frames`` with its output: the identity packed into
        words where the decoder packs this depth, else ``frame_layout``."""
        if self._wp(geom.cbps):
            return FrameLayout.identity(geom.key(), wire_pack=True)
        return frame_layout(hdrs, geom)

    @staticmethod
    def _v3_enabled() -> bool:
        """The reference's switch: FFMPEG_HT_TPU_V3=0 sends fast-profile
        streams to the BucketProgram (decoder.py:1078)."""
        return os.environ.get("FFMPEG_HT_TPU_V3", "1") != "0"

    @staticmethod
    def _negotiate(hdrs):
        """write_frame's pixel-format negotiation, before a device program
        is built: raises the reference's PatchWelcome for a stream that
        no format fits (more than 16 bits, ...)."""
        for hdr in hdrs:
            pf.negotiate(hdr.siz, hdr.colour_space, hdr.siz.rsiz)

    @trace.timed("parse")
    def _parse(self, data: bytes):
        return parse_codestream(data, bitexact=self.bitexact,
                                reduction_factor=self.reduction_factor)

    def _parse_tiles(self, hdr) -> List[Tile]:
        """T2 into codeblock objects (the object path)."""
        tiles = []
        for tileno in range(len(hdr.tiles)):
            tile = init_tile(hdr, tileno)
            decode_tile_packets(hdr, tileno, tile, self.max_layers)
            tiles.append(tile)
        return tiles

    def decode(self, data: bytes) -> DecodedFrame:
        return self.decode_async(data)()

    def decode_async(self, data: bytes):
        """Parse, upload and dispatch on the current CUDA stream without
        waiting for the device's earlier work (the lane arrays are staged
        in page-locked memory and copied asynchronously); returns a
        zero-argument callable that waits for the packed output and builds
        the DecodedFrame:

            pending = [dec.decode_async(s) for s in streams]
            frames = [p() for p in pending]

        Traced (``utils/trace``), this part is the call's ``dispatch``
        span and the callable its ``finish`` span."""
        call = trace.new_call()
        with trace.span("dispatch", call):
            hdr = self._parse(data)
            fast = self._fast_launch(hdr)
            if fast is not None:
                fg, packed, layout = fast
                fetch = self._start_fetch(packed, layout)
                fin = lambda: self._finish(hdr, fg.tiles, fg.geom, fetch())
            else:
                tiles = self._parse_tiles(hdr)
                if _supported_on_device(hdr, tiles):
                    fin = self._device_decode(hdr, tiles)
                else:
                    frame = host_decoder.decode_frame(
                        data, bitexact=self.bitexact,
                        reduction_factor=self.reduction_factor,
                        max_layers=self.max_layers)
                    self.host_frames += 1
                    fin = lambda: frame
        return _finishing(call, fin)

    def decode_stream(self, streams, depth: int = 3):
        """Pipelined decode of a frame sequence (generator): up to `depth`
        frames are parsed and dispatched ahead, so the device decodes
        frame n while the host parses frame n+1."""
        inflight = []
        for data in streams:
            inflight.append(self.decode_async(data))
            if len(inflight) >= depth:
                yield inflight.pop(0)()
        for fin in inflight:
            yield fin()

    def _fast_geom(self, hdr):
        key = FP.geometry_fingerprint(hdr)
        fg = self._geoms.get(key)
        if fg is None:
            if len(self._geoms) >= _MAX_GEOMS:   # bound the plan cache
                self._geoms.pop(next(iter(self._geoms)))
            with trace.span("build"):
                trace.count("builds")
                fg = FP.FlatGeometry(hdr)
            self._geoms[key] = fg
        return fg

    @staticmethod
    def _plan(fg):
        """The geometry's v3 assembly plan, built at its first use; False
        where it has none."""
        if fg.v3_plan is None:
            with trace.span("build"):
                trace.count("builds")
                fg.v3_plan = ASM.build_plan(fg) or False
        return fg.v3_plan

    def decode_batch(self, streams, devices=None,
                     require_shard: bool = False) -> List[DecodedFrame]:
        """Decode many frames; same-geometry streams run as ONE device
        program (the frame axis concatenates into the lane axis): the
        V3Program of F frames, or the BucketProgram over the
        frame-replicated geometry with the frames' buckets merged
        (decoder.py:712-802). Anything else decodes stream by stream
        through ``decode``.

        `devices`, a sequence of device names or torch.devices (one may
        repeat: it then runs that many shards), shards the frame axis of
        a v3 batch over them (``_decode_batch_sharded``), in place of
        the reference's `mesh`; each is resolved first, so a CUDA entry
        without a card raises. When the batch cannot shard,
        `require_shard` raises ``UnshardableBatch`` naming the reason;
        otherwise the reason is logged as a warning and the batch
        decodes on the decoder's own device.

        Traced (``utils/trace``), the part up to the fetch being queued
        is the call's ``dispatch`` span, the fetch wait and the write its
        ``finish`` span."""
        call = trace.new_call()
        with trace.span("dispatch", call):
            fin = self._batch_async(streams, devices, require_shard)
        with trace.span("finish", call):
            return fin()

    def _batch_async(self, streams, devices, require_shard):
        """``decode_batch`` up to the fetch being queued; returns the
        callable that waits for it and builds the frames."""
        if devices is not None:
            if isinstance(devices, (str, torch.device)):
                raise TypeError("devices must be a sequence of devices")
            devs = [resolve_device(d) for d in devices]
            if not devs:
                raise ValueError("devices is empty")
            fin, why = self._decode_batch_sharded(streams, devs)
            if fin is not None:
                return fin
            if require_shard:
                raise UnshardableBatch(why)
            logger.warning("decode_batch: cannot shard (%s); "
                           "decoding single-device", why)
        if not streams:
            return list
        hdrs = [self._parse(d) for d in streams]
        fast = self._fast_batch(hdrs)
        if fast is not None:
            return fast
        parsed = [(hdr, self._parse_tiles(hdr), data)
                  for hdr, data in zip(hdrs, streams)]
        if not all(_supported_on_device(h, t) for h, t, _ in parsed):
            return lambda: [self.decode(d) for _, _, d in parsed]

        self._negotiate(hdrs)
        geoms, bucket_maps, prefills = [], [], []
        for hdr, tiles, _ in parsed:
            with trace.span("lane_cols"):
                g, b, p = _build_batch(hdr, tiles)
            geoms.append(g)
            bucket_maps.append(b)
            prefills.append(p)

        g0 = geoms[0]
        if any(g.key() != g0.key() for g in geoms[1:]):
            return lambda: [self.decode(d) for _, _, d in parsed]

        F = len(parsed)
        total = g0.total
        # merge buckets: dest indices shift by f*total per frame
        merged: Dict[Tuple[int, int], _Bucket] = {}
        for f, bmap in enumerate(bucket_maps):
            for key, b in bmap.items():
                merged.setdefault(key, _Bucket(b.w, b.h)).extend(
                    b, f * total)
        prefill = np.concatenate([p[:-1] for p in prefills]
                                 + [np.zeros(1, prefills[0].dtype)])

        gm = _replicate_geometry(g0, F)
        layout = self._layout(hdrs, g0)
        fetch = self._start_fetch(self._dispatch(
            gm, merged, prefill, layout.replicate(F)), layout)
        self._dispatched("v2", g0.transform, F)
        return lambda: self._split_frames([(h, t) for h, t, _ in parsed], g0,
                                          fetch())

    def _batch_geom(self, hdrs):
        """The FlatGeometry that fast-profile streams of one geometry
        share, or None."""
        if not hdrs or not all(FP.fast_profile(h) for h in hdrs) \
                or len({FP.geometry_fingerprint(h) for h in hdrs}) != 1:
            return None
        return self._fast_geom(hdrs[0])

    def _fast_batch(self, hdrs):
        """decode_batch's flat-lane program (decoder.py:1128-1174): the
        V3Program of the F frames, else the BucketProgram on ``_v2_args``,
        dispatched; returns the callable that waits for its output and
        builds the frames, or None when the streams leave the fast
        profile or one geometry."""
        if self.max_layers:
            return None
        fg = self._batch_geom(hdrs)
        if fg is None:
            return None
        cols_list = [FP.parse_frame_flat(h, fg) for h in hdrs]
        if any(c is None for c in cols_list):
            return None
        self._negotiate(hdrs)
        F = len(hdrs)
        layout = self._layout(hdrs, fg.geom)
        v3 = self._v3_program(fg, cols_list, layout) \
            if self._v3_enabled() else None
        if v3 is not None:
            prog, args = v3
            packed = prog(**args)
            self._dispatched("v3", fg.geom.transform, F)
        else:
            geom, fin, _accum = self._v2_args(fg, cols_list)
            packed = self._dispatch_args(geom, *fin, layout.replicate(F))
            self._dispatched("v2", fg.geom.transform, F)
        fetch = self._start_fetch(packed, layout)
        return lambda: self._split_frames([(h, fg.tiles) for h in hdrs],
                                          fg.geom, fetch())

    def _shard_plan(self, streams, D: int):
        """((headers, FlatGeometry, the frames' ``build_v3_frame`` columns
        padded to a multiple of D by repeating the last, frames per shard,
        the batch's one ms_class), None), or (None, the reason the batch
        cannot shard), with the reference's reasons in its order of
        checks (decoder.py:824-896)."""
        hdrs = [self._parse(d) for d in streams]
        if not hdrs:
            return None, "empty batch"
        if self.max_layers:
            return None, "max_layers truncation is per-frame host logic"
        for i, h in enumerate(hdrs):
            if not FP.fast_profile(h):
                return None, f"stream {i} leaves the fast-lane profile " \
                    "(POC/PPM/PPT/ROI/lowres/non-HTONLY/oversize cblk)"
        if len({FP.geometry_fingerprint(h) for h in hdrs}) != 1:
            return None, "streams do not share one geometry"
        fg = self._fast_geom(hdrs[0])
        if self._plan(fg) is False or fg.ncblks == 0:
            return None, "geometry has no v3 assembly plan"
        frames = []
        for i, hdr in enumerate(hdrs):
            cols = FP.parse_frame_flat(hdr, fg)
            if cols is None:
                return None, f"stream {i} failed the native flat parse"
            fc = FP.build_v3_frame(fg, cols)
            if fc is None:
                return None, f"stream {i} has host-only codeblocks"
            frames.append(fc)
        frames.extend([frames[-1]] * ((-len(frames)) % D))
        # one class for the whole batch, as the reference's one program
        ms_class = _ms_class(frames)
        if ms_class is None:
            return None, "magnitude exponent > 25 (host-tier codeblocks)"
        return (hdrs, fg, frames, len(frames) // D, ms_class), None

    def _decode_batch_sharded(self, streams, devices):
        """Shard the frame axis of a same-geometry v3 batch over
        `devices` (resolved torch.devices): shard d runs the cached
        V3Program of its Fl frames on devices[d] with its own lane
        arguments and shard-local prefill (``finish_v3_numpy`` of its
        frames). Every shard is uploaded and launched before any fetch is
        waited for, so shards on several cards overlap. Returns (the
        callable that waits for the shards and builds the F frames, None),
        or (None, the reason) when the batch cannot shard
        (``_shard_plan``)."""
        plan, why = self._shard_plan(streams, len(devices))
        if plan is None:
            return None, why
        hdrs, fg, frames, Fl, ms_class = plan
        self._negotiate(hdrs)
        # one layout for every shard, from every header: a shard's output
        # is split in the layout its program wrote
        layout = self._layout(hdrs, fg.geom)
        fetches = []
        for d, dev in enumerate(devices):
            prog, args = self._v3_shard(fg, frames[d * Fl:(d + 1) * Fl],
                                        ms_class, dev, layout)
            with torch.cuda.device(dev) if dev.type == "cuda" \
                    else contextlib.nullcontext():
                fetches.append(self._start_fetch(prog(**args), layout))
        self._dispatched("v3", fg.geom.transform, len(hdrs))

        def finish():
            out = []
            for d, fetch in enumerate(fetches):
                # the pad frames close the last shards: split the real ones
                # only (_split_frames reads the flag at the buffer's end)
                real = hdrs[d * Fl:(d + 1) * Fl]
                out.extend(self._split_frames([(h, fg.tiles) for h in real],
                                              fg.geom, fetch()))
            return out
        return finish, None

    def bench_resident(self, streams, n_it: int = 10, reps: int = 3):
        """Device-resident decode rate for same-geometry streams
        (decoder.py:985-1052).

        Parses at full resolution whatever `reduction_factor` says, stages
        the frames' lane arrays on the device once, builds ONE V3Program
        over all F frames (no wire pack), then runs `reps` x `n_it`
        programs back to back, synchronising once per repetition: the
        rate the device sustains without the host parse and the output
        fetch. Returns {"fps", "ms_per_frame", "frames_merged"} for the
        best repetition; raises ValueError when the streams leave the
        fused fast lane (the v2 path has no resident form, as in the
        reference)."""
        hdrs = [parse_codestream(s, bitexact=self.bitexact) for s in streams]
        fg = self._batch_geom(hdrs)
        cols_list = [FP.parse_frame_flat(h, fg) for h in hdrs] if fg \
            else [None]
        if any(c is None for c in cols_list):
            raise ValueError("streams not v3-capable (fast profile, one "
                             "shared geometry, native parse)")
        self._negotiate(hdrs)
        v3 = self._v3_program(fg, cols_list, frame_layout(hdrs, fg.geom))
        if v3 is None:
            raise ValueError("streams not v3-capable (assembly plan, no "
                             "refinement lanes, maxbp <= 25)")
        prog, args = v3
        sync = (lambda: torch.cuda.synchronize(self.device)) \
            if self.device.type == "cuda" else (lambda: None)
        prog(**args)                                  # warm-up
        sync()
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(n_it):
                prog(**args)
            sync()
            best = min(best, (time.perf_counter() - t0) / n_it)
        F = len(hdrs)
        return {"fps": F / best, "ms_per_frame": best * 1e3 / F,
                "frames_merged": F}

    def _fast_launch(self, hdr):
        """(fg, packed, its FrameLayout) for a fast-profile stream: the
        V3Program, else the BucketProgram on ``build_bucket_args`` lanes
        (decoder.py:1054-1072); None when the stream leaves the flat fast
        lane (the object path decides then)."""
        if self.max_layers or not FP.fast_profile(hdr):
            return None
        fg = self._fast_geom(hdr)
        cols = FP.parse_frame_flat(hdr, fg)
        if cols is None:
            return None
        self._negotiate([hdr])
        layout = self._layout([hdr], fg.geom)
        v3 = self._v3_program(fg, [cols], layout) \
            if self._v3_enabled() else None
        if v3 is not None:
            prog, args = v3
            self._dispatched("v3", fg.geom.transform, 1)
            return fg, prog(**args), layout
        geom, fin, _accum = self._v2_args(fg, [cols])
        packed = self._dispatch_args(geom, *fin, layout)
        self._dispatched("v2", fg.geom.transform, 1)
        return fg, packed, layout

    def _v2_args(self, fg, cols_list):
        """The v2 counterpart of ``_v3_program`` for same-geometry frames
        (decoder.py:1152-1163): (the frame-replicated geometry, its
        ``finish_buckets`` quadruple (shapes, bucket_args, pf_idx, pf_val)
        as numpy arrays, the ``build_bucket_args`` accumulation it came
        from). Frame f's dests are shifted by f * total."""
        F, total = len(cols_list), fg.geom.total
        accum = None
        for f, cols in enumerate(cols_list):
            accum = FP.build_bucket_args(fg, cols, dest_shift=f * total,
                                         prev=accum)
        return (_replicate_geometry(fg.geom, F),
                FP.finish_buckets(accum, F * total), accum)

    def _v3_program(self, fg, cols_list, layout: FrameLayout):
        """(the cached V3Program for these frames, its arguments on the
        device), or None when they need the v2 path: no assembly plan, no
        codeblocks, refinement lanes or a lane with maxbp > 25. The
        program writes its frames in `layout` (``_layout``)."""
        if self._plan(fg) is False or fg.ncblks == 0:
            return None
        frames = []
        for cols in cols_list:
            fc = FP.build_v3_frame(fg, cols)
            if fc is None:
                return None
            frames.append(fc)
        ms_class = _ms_class(frames)
        if ms_class is None:
            return None
        return self._v3_shard(fg, frames, ms_class, self.device, layout)

    def _v3_shard(self, fg, frames, ms_class: int, device,
                  layout: FrameLayout):
        """(the V3Program for ``build_v3_frame`` columns `frames` at
        `ms_class`, cached in ``fg.v3_progs`` by frame count, class,
        identity step and frame layout; its arguments on `device`, written
        into one staging buffer and sent by ``to_torch`` in one copy,
        ``FP.Staging``)."""
        stage = FP.Staging(device)
        args, F = finish_v3_numpy(fg, frames, fg.geom.total, stage.alloc)
        # lossless frames: istep is uniformly the identity 32768
        no_istep = bool(np.all(args["istep"] == 32768))
        key = (F, ms_class, no_istep, layout)
        prog = fg.v3_progs.get(key)
        if prog is None:
            with trace.span("build"):
                trace.count("builds")
                prog = V3Program(fg.v3_plan, fg.geom.key(),
                                 qw=fg.v3_plan.bw // 2,
                                 qh=fg.v3_plan.bh // 2, ms_class=ms_class,
                                 n_pad=fg.ncblks, frames=F, layout=layout,
                                 no_istep=no_istep)
            fg.v3_progs[key] = prog
        return prog, stage.views(to_torch(stage.host, device), F)

    def _dispatch(self, geom: _Geometry, buckets, prefill,
                  layout: FrameLayout):
        """Pack the object path's buckets and run the BucketProgram into
        frame layout `layout` (no host sync; decoder.py:938-970): lane
        arrays per bucket in key order, and the host-decoded samples as a
        sparse prefill."""
        with trace.span("lane_args"):
            packed = [buckets[key].pack() for key in sorted(buckets)]
            shapes = [shape for shape, _ in packed]
            bucket_args = [args for _, args in packed]
            nz = np.nonzero(prefill[:-1])[0]
            if len(nz):
                pf_idx = nz.astype(np.int32)
                pf_val = prefill[nz]
            else:
                pf_idx = np.array([geom.total], np.int32)
                pf_val = np.zeros(1, prefill.dtype)
        return self._dispatch_args(geom, shapes, bucket_args, pf_idx, pf_val,
                                   layout)

    def _dispatch_args(self, geom: _Geometry, shapes, bucket_args, pf_idx,
                       pf_val, layout: FrameLayout):
        """The BucketProgram on prepacked numpy bucket arrays, writing
        frame layout `layout`: upload, then entropy + assembly
        (decoder.py:972-981)."""
        up = lambda v: to_torch(v, self.device) \
            if isinstance(v, np.ndarray) else v
        prog = bucket_program(tuple(map(tuple, shapes)), geom.key(), layout)
        return prog(up(pf_idx), up(pf_val),
                    [{k: up(v) for k, v in a.items()} for a in bucket_args])

    def _device_decode(self, hdr, tiles):
        """The object path of ``decode_async``: bucket the codeblocks,
        upload, dispatch (no host sync), queue the fetch and return the
        callable that finishes the frame."""
        self._negotiate([hdr])
        with trace.span("lane_cols"):
            geom, buckets, prefill = _build_batch(hdr, tiles)
        layout = self._layout([hdr], geom)
        fetch = self._start_fetch(self._dispatch(geom, buckets, prefill,
                                                 layout), layout)
        self._dispatched("v2", geom.transform, 1)
        return lambda: self._finish(hdr, tiles, geom, fetch())

    def _dispatched(self, route: str, transform: int, frames: int) -> None:
        """Count `frames` dispatched to a program: ``v3_frames`` or
        ``v2_frames`` by `route`, and the trace counter ``float97_frames``
        where they take the float 9/7."""
        if route == "v3":
            self.v3_frames += frames
        else:
            self.v2_frames += frames
        if transform == mk.DWT97:
            trace.count("float97_frames", frames)

    def _start_fetch(self, packed, layout: FrameLayout):
        """Queue the device-to-host copy of the packed output, which a
        program wrote in `layout`, behind the decode; the returned callable
        waits for it (span ``fetch``) and gives (the host copy, `layout`),
        what ``_split_frames`` takes."""
        if packed.device.type != "cuda":
            def fetch():
                with trace.span("fetch"):
                    return packed, layout
            return fetch
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(packed.device))

        def fetch():
            with trace.span("fetch"):
                done.synchronize()
            return host, layout
        return fetch

    def _finish(self, hdr, tiles, geom, packed) -> DecodedFrame:
        return self._split_frames([(hdr, tiles)], geom, packed)[0]

    @trace.timed("write")
    def _split_frames(self, frames, geom, packed) -> List[DecodedFrame]:
        """`packed` = (the output of a program whose first len(frames)
        frames are the (hdr, tiles) frames of one geometry, the per-frame
        ``FrameLayout`` that program wrote) -> DecodedFrames; raises
        InvalidData when the ok flag, the buffer's last element, is
        clear. Frames after them (a shard's pad frames) are dropped.

        In a pixel format's layout each plane of each frame is one copy
        out of the buffer into memory of its own (a frame never holds the
        fetched, page-locked buffer; counter ``device_layout_frames``).
        A wire-packed output is unpacked first (decoder.py:632-642), and
        an output in the identity layout is written into frames by
        ``_assemble_frame``."""
        buf, layout = packed
        buf = buf.numpy()
        if layout.wire_pack:                 # wire words, uint32 bits
            words = buf.view(np.uint32)
            n = len(frames) * geom.total
            buf = np.empty(n + 1, np.uint16)
            unpack_words(words[:-1], geom.cbps, n, out=buf)
            buf[-1] = np.uint16(words[-1])
        elif buf.dtype == np.int16:
            buf = buf.view(np.uint16)
        if buf[-1] == 0:
            raise InvalidData("invalid HT codestream (U bound violated)")
        if layout.fmt is None:
            return self._assembled_frames(frames, geom, buf)
        out = []
        for f in range(len(frames)):
            base = f * layout.frame_size
            out.append(DecodedFrame(
                fmt=layout.fmt, width=layout.width, height=layout.height,
                planes=[buf[base + o:base + o + h * w].reshape(h, w).copy()
                        for o, h, w in layout.planes]))
        trace.count("device_layout_frames", len(frames))
        return out

    def _assembled_frames(self, frames, geom, buf) -> List[DecodedFrame]:
        """The frames of samples `buf` in the identity layout, each
        written by its own header (``_assemble_frame``)."""
        out = []
        off = 0
        for hdr, tiles in frames:
            outs = []
            for (_o, ph, pw) in geom.planes:
                outs.append(buf[off:off + ph * pw].reshape(ph, pw))
                off += ph * pw
            out.append(self._assemble_frame(hdr, tiles, outs))
        return out

    def _assemble_frame(self, hdr, tiles, outs) -> DecodedFrame:
        """write_frame semantics on device output (host side)."""
        siz = hdr.siz
        fmt = pf.negotiate(siz, hdr.colour_space, siz.rsiz)
        precision = pf.output_precision(fmt, siz.precision)
        dimx, dimy = host_decoder._frame_dims(hdr)
        planes = pf.alloc_frame(fmt, dimx, dimy)
        cdef = _cdef(hdr)
        k = 0
        for tile in tiles:
            comp_planes = []
            for _compno in range(len(tile.comp)):
                comp_planes.append(outs[k].astype(np.int64))
                k += 1
            _write_frame_prescaled(hdr, tile, comp_planes, fmt, planes,
                                   precision, cdef)
        return DecodedFrame(fmt=fmt, width=dimx, height=dimy, planes=planes)


def _finishing(call: int, fin):
    """`fin` timed as the ``finish`` span of entry call `call`."""
    def finish():
        with trace.span("finish", call):
            return fin()
    return finish


def _write_frame_prescaled(hdr, tile, comp_planes, fmt, planes, precision,
                           cdef):
    """write_frame for device output (already DC-shifted and clipped)."""
    siz = hdr.siz
    for compno, comp in enumerate(tile.comp):
        cbps = siz.components[compno].depth
        cdx = siz.components[compno].dx
        cdy = siz.components[compno].dy
        vals = comp_planes[compno] << (precision - cbps)
        x0 = comp.coord[0][0] - ceildiv(siz.x0, cdx)
        y0 = comp.coord[1][0] - ceildiv(siz.y0, cdy)
        w = comp.coord[0][1] - ceildiv(siz.x0, cdx)
        h = comp.coord[1][1] - ceildiv(siz.y0, cdy)
        if fmt.planar:
            plane_idx = (cdef[compno] - 1) if cdef[compno] \
                else fmt.nb_components - 1
            planes[plane_idx][y0:h, x0:w] = vals
        else:
            nc = fmt.nb_components
            planes[0][y0:h, x0 * nc + compno:w * nc:nc] = vals[:, :w - x0]


def decode_frame_cuda(data: bytes, bitexact: bool = True,
                      reduction_factor: int = 0,
                      device="cuda") -> DecodedFrame:
    """One-shot convenience wrapper around Decoder (the counterpart of
    the reference's ``decode_frame_tpu``)."""
    return Decoder(device=device, bitexact=bitexact,
                   reduction_factor=reduction_factor).decode(data)
