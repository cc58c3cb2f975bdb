"""Host (NumPy) reference decoder — the end-to-end oracle.

Full decode on CPU: parse -> T2 -> entropy (HT or MQ) -> dequant -> inverse
DWT -> inverse MCT -> frame packing. This is the bit-exactness oracle the
TPU pipeline is validated against, and the fallback path for exotic
features. Pipeline parity: jpeg2000_decode_frame / jpeg2000_decode_tile
(jpeg2000dec.c:2368-2395, 2825-2903).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from ffmpeg_ht_tpu_torch.codestream import markers as mk
from ffmpeg_ht_tpu_torch.codestream.geometry import Tile, ceildiv, init_tile
from ffmpeg_ht_tpu_torch.codestream.parser import parse_codestream
from ffmpeg_ht_tpu_torch.codestream.structures import MainHeader
from ffmpeg_ht_tpu_torch.codestream.t2 import decode_tile_packets
from ffmpeg_ht_tpu_torch.models import pixfmt as pf
from ffmpeg_ht_tpu_torch.ops import dequant as dq
from ffmpeg_ht_tpu_torch.ops import dwt as dwtmod
from ffmpeg_ht_tpu_torch.ops import ebcot, ht_dec, mct
from ffmpeg_ht_tpu_torch.utils.errors import InvalidData, PatchWelcome
from ffmpeg_ht_tpu_torch.utils.log import logger


@dataclass
class DecodedFrame:
    fmt: pf.PixFmt
    width: int
    height: int
    planes: List[np.ndarray]
    tlm_skipped: int = 0     # bytes skipped via TLM (decode_tile)

    def tobytes(self) -> bytes:
        return pf.pack_rawvideo(self.fmt, self.planes)


def _frame_dims(hdr: MainHeader):
    siz = hdr.siz
    red = hdr.reduction_factor
    o_dimx = -((-(siz.width - siz.x0)) >> red)
    o_dimy = -((-(siz.height - siz.y0)) >> red)
    dimx = dimy = 0
    for c in siz.components:
        dimx = max(dimx, ceildiv(o_dimx, c.dx))
        dimy = max(dimy, ceildiv(o_dimy, c.dy))
    return dimx, dimy


def _tile_codeblocks(hdr: MainHeader, tile: Tile):
    """Entropy decode + dequant + DWT per component (jpeg2000dec.c:2212-2299).

    Returns list of per-component planes (int32 or float32).
    """
    planes = []
    for compno, comp in enumerate(tile.comp):
        codsty = tile.codsty[compno]
        qntsty = tile.qntsty[compno]
        cw = comp.coord[0][1] - comp.coord[0][0]
        ch = comp.coord[1][1] - comp.coord[1][0]
        if codsty.transform == mk.DWT97:
            plane = np.zeros((ch, cw), dtype=np.float32)
        else:
            plane = np.zeros((ch, cw), dtype=np.int32)

        coded = False
        subbandno = 0
        for reslevelno in range(codsty.nreslevels2decode):
            rlevel = comp.reslevel[reslevelno]
            for bandno, band in enumerate(rlevel.band):
                magb = qntsty.expn[subbandno] + qntsty.nguardbits - 1
                subbandno += 1
                bandpos = bandno + (1 if reslevelno > 0 else 0)
                if (band.coord[0][0] == band.coord[0][1]
                        or band.coord[1][0] == band.coord[1][1]):
                    continue
                if (codsty.cblk_style & mk.CTSY_HTJ2K_F) and magb >= 31:
                    raise PatchWelcome("HT with M_b >= 31")

                for prec in band.prec:
                    for cblk in prec.cblk:
                        w = cblk.width
                        h = cblk.height
                        if w <= 0 or h <= 0:
                            continue
                        if cblk.modes & mk.CTSY_HTJ2K_F:
                            t1 = ht_dec.decode_htj2k(
                                bytes(cblk.data), cblk.npasses, cblk.zbp,
                                cblk.pass_lengths, w, h, magb,
                                comp.roi_shift,
                                cblk.modes & mk.CBLK_VSC)
                            ok = cblk.npasses > 0
                        else:
                            t1 = ebcot.decode_cblk(
                                bytes(cblk.data), cblk.npasses,
                                cblk.nonzerobits, cblk.modes, w, h, bandpos,
                                magb, comp.roi_shift, cblk.nb_terminations,
                                cblk.data_start, codsty.log2_cblk_width)
                            ok = cblk.length > 0
                        if not ok:
                            continue
                        coded = True
                        x = cblk.coord[0][0] - band.coord[0][0]
                        y = cblk.coord[1][0] - band.coord[1][0]
                        if codsty.transform == mk.DWT97:
                            blk = dq.dequant_float(t1, band.f_stepsize, magb)
                        elif codsty.transform == mk.DWT97_INT:
                            blk = dq.dequant_int_97(t1, band.f_stepsize, magb)
                        else:
                            blk = dq.dequant_int(t1, band.i_stepsize, magb)
                        plane[y:y + h, x:x + w] = blk

        if coded:
            dwt_border = comp.coord
            dwtmod.dwt_decode(plane, dwt_border,
                              codsty.nreslevels2decode - 1, codsty.transform)
        planes.append(plane)
    return planes


def _write_frame(hdr: MainHeader, tile: Tile, comp_planes, fmt: pf.PixFmt,
                 planes: List[np.ndarray], precision: int, cdef) -> None:
    """DC shift + clip + pack (write_frame_8/16, jpeg2000dec.c:2301-2364)."""
    siz = hdr.siz
    for compno, comp in enumerate(tile.comp):
        codsty = tile.codsty[compno]
        cbps = siz.components[compno].depth
        cdx = siz.components[compno].dx
        cdy = siz.components[compno].dy
        data = comp_planes[compno]

        x0 = comp.coord[0][0] - ceildiv(siz.x0, cdx)
        y0 = comp.coord[1][0] - ceildiv(siz.y0, cdy)
        w = comp.coord[0][1] - ceildiv(siz.x0, cdx)
        h = comp.coord[1][1] - ceildiv(siz.y0, cdy)

        if codsty.transform == mk.DWT97:
            # lrintf: round-half-to-even (IEEE default)
            vals = np.rint(data).astype(np.int64) + (1 << (cbps - 1))
        else:
            vals = data.astype(np.int64) + (1 << (cbps - 1))
        vals = np.clip(vals, 0, (1 << cbps) - 1)
        vals = vals << (precision - cbps)

        if fmt.planar:
            plane_idx = (cdef[compno] - 1) if cdef[compno] else fmt.nb_components - 1
            planes[plane_idx][y0:h, x0:w] = vals
        else:
            nc = fmt.nb_components
            planes[0][y0:h, x0 * nc + compno:w * nc:nc] = vals[:, :w - x0]


def decode_frame(data: bytes, bitexact: bool = False,
                 reduction_factor: int = 0,
                 max_layers: int = 0) -> DecodedFrame:
    """Decode one J2C/JP2/JPH frame entirely on host."""
    hdr = parse_codestream(data, bitexact=bitexact,
                           reduction_factor=reduction_factor)
    siz = hdr.siz
    fmt = pf.negotiate(siz, hdr.colour_space, siz.rsiz)
    precision = pf.output_precision(fmt, siz.precision)
    dimx, dimy = _frame_dims(hdr)
    planes = pf.alloc_frame(fmt, dimx, dimy)

    # cdef defaulting (jpeg2000dec.c:2883-2892)
    cdef = hdr.cdef if hdr.cdef else [-1] * 4
    if any(c < 0 for c in cdef[:siz.ncomponents]):
        cdef = [i + 1 for i in range(4)]
        if siz.ncomponents % 2 == 0:
            cdef[siz.ncomponents - 1] = 0

    for tileno in range(len(hdr.tiles)):
        tile = init_tile(hdr, tileno)
        decode_tile_packets(hdr, tileno, tile, max_layers)
        comp_planes = _tile_codeblocks(hdr, tile)
        if tile.codsty[0].mct:
            _mct(tile, comp_planes)
        _write_frame(hdr, tile, comp_planes, fmt, planes, precision, cdef)

    return DecodedFrame(fmt=fmt, width=dimx, height=dimy, planes=planes)


def decode_tile(data: bytes, tileno: int, bitexact: bool = False,
                max_layers: int = 0) -> DecodedFrame:
    """Random-access decode of ONE tile (TLM-indexed, VERDICT r2 item 7).

    When the stream carries a TLM table (jpeg2000dec.c:901-930), the
    parser seeks over every other tile's tile-parts without reading a
    byte of them; without TLM the other parts are still walked (headers
    only) but never entropy-decoded. Returns a DecodedFrame covering the
    full canvas with only `tileno` decoded (other regions zero) —
    matching decode_frame's geometry so callers can crop the tile
    rectangle (hdr-independent composition)."""
    hdr = parse_codestream(data, bitexact=bitexact, only_tile=tileno)
    if tileno < 0 or tileno >= len(hdr.tiles):
        raise InvalidData(f"tile {tileno} out of range")
    if not hdr.tiles[tileno].tile_parts:
        raise InvalidData(f"tile {tileno} has no tile-part data")
    siz = hdr.siz
    fmt = pf.negotiate(siz, hdr.colour_space, siz.rsiz)
    precision = pf.output_precision(fmt, siz.precision)
    dimx, dimy = _frame_dims(hdr)
    planes = pf.alloc_frame(fmt, dimx, dimy)
    cdef = hdr.cdef if hdr.cdef else [-1] * 4
    if any(c < 0 for c in cdef[:siz.ncomponents]):
        cdef = [i + 1 for i in range(4)]
        if siz.ncomponents % 2 == 0:
            cdef[siz.ncomponents - 1] = 0
    tile = init_tile(hdr, tileno)
    decode_tile_packets(hdr, tileno, tile, max_layers)
    comp_planes = _tile_codeblocks(hdr, tile)
    if tile.codsty[0].mct:
        _mct(tile, comp_planes)
    _write_frame(hdr, tile, comp_planes, fmt, planes, precision, cdef)
    frame = DecodedFrame(fmt=fmt, width=dimx, height=dimy, planes=planes)
    frame.tlm_skipped = hdr.tlm_skipped
    return frame


def _mct(tile: Tile, comp_planes) -> None:
    """mct_decode parity (jpeg2000dec.c:2183-2209)."""
    for i in (1, 2):
        if tile.codsty[0].transform != tile.codsty[i].transform:
            logger.error("Transforms mismatch, MCT not supported")
            return
        if tile.comp[0].coord != tile.comp[i].coord:
            logger.error("Coords mismatch, MCT not supported")
            return
    c0, c1, c2 = mct.mct_decode(tile.codsty[0].transform,
                                comp_planes[0], comp_planes[1], comp_planes[2])
    comp_planes[0][:] = c0
    comp_planes[1][:] = c1
    comp_planes[2][:] = c2
