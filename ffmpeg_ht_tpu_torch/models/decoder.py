"""HTJ2K decoder on a torch device (counterpart of
``ffmpeg_ht_tpu.models.decoder.Decoder``).

The host tier is the port's own copy of the reference's: codestream
parse, the flat fast lane (native T2 parse, lane building, assembly
plan), the host oracle and the frame writer. The device program is
``models/assembly.V3Program``: the v3 fused fast lane of the reference
package, for HTONLY streams with any of the three transforms (reversible
5/3, integer 9/7 with ``bitexact=True``, float 9/7 with
``bitexact=False``), band-direct or through the flat-DWT fallback.

Routing follows the reference ``Decoder.decode``:

- streams the reference hands to the host oracle (legacy MQ codeblocks,
  ROI, unsupported transforms, ...) go to the same
  ``host_decoder.decode_frame``;
- v3-eligible streams (``fast_profile``, an assembly plan, no refinement
  lanes, maxbp <= 25) run the V3Program on the device;
- streams the reference decodes on its device by another route (the v2
  bucketed path, maxbp > 25) raise NotImplementedError naming their
  ROADMAP.md item. They are never decoded on the host in their place.

``decode_batch`` runs same-geometry frames as one F-frame program on one
device; ``bench_resident`` times that program with its inputs already on
the device. Not ported: ``reduction_factor``, ``max_layers``, the wire
pack and sharding ``decode_batch`` over several devices (ROADMAP.md).
"""

from __future__ import annotations

import time
from typing import List

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
from ffmpeg_ht_tpu_torch.models.assembly import V3Program
from ffmpeg_ht_tpu_torch.models.fastpath import finish_v3_numpy, to_torch
from ffmpeg_ht_tpu_torch.models.host_decoder import DecodedFrame
from ffmpeg_ht_tpu_torch.utils.device import resolve_device
from ffmpeg_ht_tpu_torch.utils.errors import InvalidData

_V2_PATH = ("the stream needs the v2 bucketed device path (refinement "
            "passes, unaligned band origins or a non-native parse), not "
            "ported yet: ROADMAP.md, What remains item 1, the v2 path "
            "with ht_refine")
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


class Decoder:
    """HTJ2K decoder whose device program runs on `device`.

    `device` is required to exist: "cuda" without a usable card raises,
    and nothing falls back to the CPU. decode(data) -> DecodedFrame, at
    full resolution. `bitexact` picks the irreversible path as in the
    reference ``Decoder(bitexact=...)``: True decodes 9/7 streams with the
    integer 9/7 (byte-identical to ``ffmpeg -flags +bitexact``), False
    with the float 9/7 (within 1 LSB). The parse records the choice in
    each codestream's transform, which the geometry cache key holds.
    """

    def __init__(self, device="cuda", bitexact: bool = True):
        self.device = resolve_device(device)
        self.bitexact = bitexact
        self._geoms = {}        # geometry fingerprint -> FlatGeometry
        self.v3_frames = 0      # frames decoded by the V3Program
        self.host_frames = 0    # frames routed to the host oracle

    def decode(self, data: bytes) -> DecodedFrame:
        return self.decode_async(data)()

    def decode_async(self, data: bytes):
        """Parse, upload and dispatch on the current CUDA stream without
        waiting for the device's earlier work (the lane arrays are staged
        in page-locked memory and copied asynchronously); returns a zero-argument callable that
        waits for the packed output and builds the DecodedFrame:

            pending = [dec.decode_async(s) for s in streams]
            frames = [p() for p in pending]
        """
        hdr = parse_codestream(data, bitexact=self.bitexact)
        fast = self._fast_launch(hdr)
        if fast is not None:
            fg, packed = fast
            fetch = self._start_fetch(packed)
            self.v3_frames += 1
            return lambda: self._finish(hdr, fg.tiles, fg.geom, fetch())
        tiles = []
        for tileno in range(len(hdr.tiles)):
            tile = init_tile(hdr, tileno)
            decode_tile_packets(hdr, tileno, tile, 0)
            tiles.append(tile)
        if not _supported_on_device(hdr, tiles):
            frame = host_decoder.decode_frame(data, bitexact=self.bitexact)
            self.host_frames += 1
            return lambda: frame
        raise NotImplementedError(_V2_PATH)

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
            fg = FP.FlatGeometry(hdr)
            self._geoms[key] = fg
        return fg

    def decode_batch(self, streams) -> List[DecodedFrame]:
        """Decode many frames; same-geometry fast-profile streams run as
        ONE V3Program of F frames (the frame axis concatenates into the
        lane axis: one launch of each kernel for the batch). Anything else
        decodes stream by stream through ``decode`` (decoder.py:758-770),
        and so still raises for streams that need the v2 path."""
        hdrs = [parse_codestream(d, bitexact=self.bitexact) for d in streams]
        fast = self._fast_batch(hdrs)
        if fast is not None:
            return fast
        return [self.decode(d) for d in streams]

    def _batch_geom(self, hdrs):
        """The FlatGeometry that fast-profile streams of one geometry
        share, or None."""
        if not hdrs or not all(FP.fast_profile(h) for h in hdrs) \
                or len({FP.geometry_fingerprint(h) for h in hdrs}) != 1:
            return None
        return self._fast_geom(hdrs[0])

    def _fast_batch(self, hdrs):
        """decode_batch's one-program lane (decoder.py:1128-1174), or None
        when the streams leave the fast profile or one geometry."""
        fg = self._batch_geom(hdrs)
        if fg is None:
            return None
        cols_list = [FP.parse_frame_flat(h, fg) for h in hdrs]
        if any(c is None for c in cols_list):
            return None
        prog, args = self._v3_program(fg, cols_list)
        host = self._start_fetch(prog(**args))()
        self.v3_frames += len(hdrs)
        return self._split_frames(hdrs, fg.tiles, fg.geom, host)

    def bench_resident(self, streams, n_it: int = 10, reps: int = 3):
        """Device-resident decode rate for same-geometry streams
        (decoder.py:985-1052).

        Stages the frames' lane arrays on the device once, builds ONE
        V3Program over all F frames, then runs `reps` x `n_it` programs
        back to back, synchronising once per repetition: the rate the
        device sustains without the host parse and the output fetch.
        Returns {"fps", "ms_per_frame", "frames_merged"} for the best
        repetition; raises ValueError when the streams leave the fused
        fast lane."""
        hdrs = [parse_codestream(s, bitexact=self.bitexact)
                for s in streams]
        fg = self._batch_geom(hdrs)
        cols_list = [FP.parse_frame_flat(h, fg) for h in hdrs] if fg \
            else [None]
        if any(c is None for c in cols_list):
            raise ValueError("streams not v3-capable (fast profile, one "
                             "shared geometry, native parse)")
        try:
            prog, args = self._v3_program(fg, cols_list)
        except NotImplementedError as e:
            raise ValueError(f"streams not v3-capable: {e}") from e
        sync = torch.cuda.synchronize if self.device.type == "cuda" \
            else (lambda: None)
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
        """(fg, packed) for a fast-profile stream, None when the stream
        leaves the flat fast lane (the object path decides then)."""
        if not FP.fast_profile(hdr):
            return None
        fg = self._fast_geom(hdr)
        cols = FP.parse_frame_flat(hdr, fg)
        if cols is None:
            return None
        prog, args = self._v3_program(fg, [cols])
        return fg, prog(**args)

    def _v3_program(self, fg, cols_list):
        """(the cached V3Program for these frames, its arguments on the
        device); raises NotImplementedError when they need the v2 path."""
        if fg.v3_plan is None:
            fg.v3_plan = ASM.build_plan(fg) or False
        if fg.v3_plan is False or fg.ncblks == 0:
            raise NotImplementedError(_V2_PATH)
        frames = []
        for cols in cols_list:
            fc = FP.build_v3_frame(fg, cols)
            if fc is None:
                raise NotImplementedError(_V2_PATH)
            frames.append(fc)
        mb = 1
        for fc in frames:
            devl = fc["qws"] > 0
            if devl.any():
                mb = max(mb, int(fc["maxbp"][devl].max()))
        if mb > 25:
            raise NotImplementedError(
                "codeblocks with maxbp > 25 need the v2 path, not ported "
                "yet: ROADMAP.md, What remains item 1, the v2 path with "
                "ht_refine")
        ms_class = next(c for c in (8, 12, 16, 20, 25) if mb <= c)
        args, F = finish_v3_numpy(fg, frames, fg.geom.total)
        # lossless frames: istep is uniformly the identity 32768
        no_istep = bool(np.all(args["istep"] == 32768))
        key = (F, ms_class, no_istep)
        prog = fg.v3_progs.get(key)
        if prog is None:
            prog = V3Program(fg.v3_plan, fg.geom.key(),
                             qw=fg.v3_plan.bw // 2, qh=fg.v3_plan.bh // 2,
                             ms_class=ms_class, n_pad=fg.ncblks, frames=F,
                             no_istep=no_istep)
            fg.v3_progs[key] = prog
        return prog, {k: to_torch(v, self.device) for k, v in args.items()}

    def _start_fetch(self, packed):
        """Queue the device-to-host copy of the packed output behind the
        decode; the returned callable waits for it."""
        if packed.device.type != "cuda":
            return lambda: packed
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(packed.device))

        def fetch():
            done.synchronize()
            return host
        return fetch

    def _finish(self, hdr, tiles, geom, packed) -> DecodedFrame:
        return self._split_frames([hdr], tiles, geom, packed)[0]

    def _split_frames(self, hdrs, tiles, geom, packed) -> List[DecodedFrame]:
        """The packed output of len(hdrs) frames of one geometry ->
        DecodedFrames; raises InvalidData when the ok flag is clear."""
        buf = packed.numpy()
        if buf.dtype == np.int16:
            buf = buf.view(np.uint16)
        if buf[-1] == 0:
            raise InvalidData("invalid HT codestream (U bound violated)")
        frames = []
        off = 0
        for hdr in hdrs:
            outs = []
            for (_o, ph, pw) in geom.planes:
                outs.append(buf[off:off + ph * pw].reshape(ph, pw))
                off += ph * pw
            frames.append(self._assemble_frame(hdr, tiles, outs))
        return frames

    def _assemble_frame(self, hdr, tiles, outs) -> DecodedFrame:
        """write_frame semantics on device output (host side)."""
        siz = hdr.siz
        fmt = pf.negotiate(siz, hdr.colour_space, siz.rsiz)
        precision = pf.output_precision(fmt, siz.precision)
        dimx, dimy = host_decoder._frame_dims(hdr)
        planes = pf.alloc_frame(fmt, dimx, dimy)
        cdef = hdr.cdef if hdr.cdef else [-1] * 4
        if any(c < 0 for c in cdef[:siz.ncomponents]):
            cdef = [i + 1 for i in range(4)]
            if siz.ncomponents % 2 == 0:
                cdef[siz.ncomponents - 1] = 0
        k = 0
        for tile in tiles:
            comp_planes = []
            for _compno in range(len(tile.comp)):
                comp_planes.append(outs[k].astype(np.int64))
                k += 1
            _write_frame_prescaled(hdr, tile, comp_planes, fmt, planes,
                                   precision, cdef)
        return DecodedFrame(fmt=fmt, width=dimx, height=dimy, planes=planes)


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

