"""Tile/component/resolution/band/precinct/code-block geometry.

Implements the coordinate algebra of ISO 15444-1:2002 B.5-B.7 with behavior
parity against ff_jpeg2000_init_component (jpeg2000.c:274-577) and init_tile
(jpeg2000dec.c:1016-1070). This grid is *the* static shape that keys the
jitted TPU pipeline: a (tile dims, levels, cblk size) tuple maps to one
compiled executable.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List

from htbench.frozen.codestream import markers as mk
from htbench.frozen.codestream.structures import (CodingStyle, MainHeader,
                                                 QuantStyle)
from htbench.frozen.codestream.tagtree import TagTree
from htbench.frozen.utils.errors import InvalidData

# float32 literals in the reference (jpeg2000dwt.h:33-34 have the `f`
# suffix) — the stepsize chain composes THESE values, and pow() sees the
# float32-rounded base promoted to double; using the double literals
# drifts the product by ulps that surface as +-1 LSB pixels in the
# 9/7-int path (found by tools/fuzz_params.py)
import numpy as _np

F_LFTG_K = float(_np.float32(1.230174104914001))
F_LFTG_X = float(_np.float32(0.812893066115961))


def ceildiv(a: int, b: int) -> int:
    return -(-a // b)


def ceildivpow2(a: int, b: int) -> int:
    return -((-a) >> b)


def exp2fi(x: int) -> float:
    """2**x rounded like av_int2float((x+127)<<23) (jpeg2000.c:207-212)."""
    return math.ldexp(1.0, x)


@dataclass
class Codeblock:
    # coord[axis][lo/hi] in band-relative "tile grid" coords after the
    # subband shift of jpeg2000.c:364-376
    coord: list
    lblock: int = 3
    length: int = 0
    npasses: int = 0
    incl: bool = False
    nonzerobits: int = 0
    zbp: int = 0
    modes: int = 0
    ht_plhd: bool = False
    pass_lengths: list = field(default_factory=lambda: [0, 0])
    data: bytearray = field(default_factory=bytearray)
    # legacy-path termination bookkeeping (jpeg2000dec.c:1511-1517)
    nb_terminations: int = 0
    nb_terminationsinc: int = 0
    data_start: list = field(default_factory=lambda: [0])
    lengthinc: list = field(default_factory=list)

    @property
    def width(self) -> int:
        return self.coord[0][1] - self.coord[0][0]

    @property
    def height(self) -> int:
        return self.coord[1][1] - self.coord[1][0]


@dataclass
class Precinct:
    coord: list
    nb_codeblocks_width: int
    nb_codeblocks_height: int
    cblk: List[Codeblock]
    cblkincl: TagTree
    zerobits: TagTree
    decoded_layers: int = 0


@dataclass
class Band:
    coord: list
    log2_cblk_width: int
    log2_cblk_height: int
    f_stepsize: float
    i_stepsize: int
    prec: List[Precinct]


@dataclass
class ResLevel:
    coord: list
    log2_prec_width: int
    log2_prec_height: int
    nbands: int
    num_precincts_x: int
    num_precincts_y: int
    band: List[Band]


@dataclass
class Component:
    coord: list       # reduced coordinates
    coord_o: list     # original coordinates
    reslevel: List[ResLevel]
    roi_shift: int = 0

    @property
    def width(self) -> int:
        return self.coord[0][1] - self.coord[0][0]

    @property
    def height(self) -> int:
        return self.coord[1][1] - self.coord[1][0]


@dataclass
class Tile:
    coord: list
    comp: List[Component]
    codsty: List[CodingStyle]
    qntsty: List[QuantStyle]


def band_stepsize(codsty: CodingStyle, qntsty: QuantStyle, bandno: int,
                  gbandno: int, reslevelno: int, cbps: int) -> tuple:
    """(f_stepsize, i_stepsize) per init_band_stepsize (jpeg2000.c:214-272).

    f_stepsize is a C *float* field in the reference: every `*=` rounds
    the double product back to float32 on store. Composing the chain in
    double and rounding once at the end differs by 1 ulp near rounding
    boundaries, which surfaces as +-1 LSB pixels in the 9/7-int path at
    high bit depths (found by tools/fuzz_params.py trial 199)."""
    import numpy as np

    if qntsty.quantsty == mk.QSTY_NONE:
        f = np.float32(1.0)
    else:  # QSTY_SI falls through to QSTY_SE in the reference too
        gain = cbps
        f = np.float32(exp2fi(gain - qntsty.expn[gbandno]))
        f = np.float32(float(f) * (qntsty.mant[gbandno] / 2048.0 + 1.0))

    if codsty.transform != mk.DWT53:
        lband = 0
        bp = bandno + (1 if reslevelno > 0 else 0)
        if bp in (1, 2):
            f = np.float32(float(f) * (F_LFTG_X * 2))
            lband = 1
        elif bp == 3:
            # C: F_LFTG_X * F_LFTG_X rounds to float before the * 4
            xx = float(np.float32(F_LFTG_X * F_LFTG_X))
            f = np.float32(float(f) * (xx * 4))
        f = np.float32(float(f) * F_LFTG_K
                       ** (2 * (codsty.nreslevels2decode - reslevelno)
                           + lband - 2))

    if float(f) > ((1 << 31) - 1) >> 15:
        f = np.float32(0.0)
    # (int)floorf(f_stepsize * (1 << 15)): float multiply, then floor
    i = int(math.floor(float(f * np.float32(1 << 15))))
    return float(f), i


def _init_band(comp: Component, codsty: CodingStyle, qntsty: QuantStyle,
               reslevel: ResLevel, reslevelno: int, bandno: int, gbandno: int,
               cbps: int) -> Band:
    declvl = codsty.nreslevels - reslevelno
    f_step, i_step = band_stepsize(codsty, qntsty, bandno, gbandno, reslevelno, cbps)

    if reslevelno == 0:
        coord = [[ceildivpow2(comp.coord_o[i][j], declvl - 1)
                  for j in range(2)] for i in range(2)]
        log2_band_prec_w = reslevel.log2_prec_width
        log2_band_prec_h = reslevel.log2_prec_height
        log2_cblk_w = min(codsty.log2_cblk_width, reslevel.log2_prec_width)
        log2_cblk_h = min(codsty.log2_cblk_height, reslevel.log2_prec_height)
    else:
        coord = [[ceildivpow2(comp.coord_o[i][j]
                              - ((((bandno + 1) >> i) & 1) << (declvl - 1)),
                              declvl)
                  for j in range(2)] for i in range(2)]
        log2_cblk_w = min(codsty.log2_cblk_width, reslevel.log2_prec_width - 1)
        log2_cblk_h = min(codsty.log2_cblk_height, reslevel.log2_prec_height - 1)
        log2_band_prec_w = reslevel.log2_prec_width - 1
        log2_band_prec_h = reslevel.log2_prec_height - 1

    precincts = []
    for precno in range(reslevel.num_precincts_x * reslevel.num_precincts_y):
        precincts.append(_init_prec(comp, reslevel, coord, precno,
                                    bandno, reslevelno,
                                    log2_band_prec_w, log2_band_prec_h,
                                    log2_cblk_w, log2_cblk_h))

    return Band(coord=coord, log2_cblk_width=log2_cblk_w,
                log2_cblk_height=log2_cblk_h,
                f_stepsize=f_step, i_stepsize=i_step, prec=precincts)


def _init_prec(comp: Component, reslevel: ResLevel, band_coord: list,
               precno: int, bandno: int, reslevelno: int,
               log2_band_prec_w: int, log2_band_prec_h: int,
               log2_cblk_w: int, log2_cblk_h: int) -> Precinct:
    # precinct coords (jpeg2000.c:291-309)
    px0 = (((reslevel.coord[0][0] >> reslevel.log2_prec_width)
            + precno % reslevel.num_precincts_x) << log2_band_prec_w)
    py0 = (((reslevel.coord[1][0] >> reslevel.log2_prec_height)
            + precno // reslevel.num_precincts_x) << log2_band_prec_h)
    px1 = min(px0 + (1 << log2_band_prec_w), band_coord[0][1])
    py1 = min(py0 + (1 << log2_band_prec_h), band_coord[1][1])
    px0 = max(px0, band_coord[0][0])
    py0 = max(py0, band_coord[1][0])
    coord = [[px0, px1], [py0, py1]]

    nb_w = ceildivpow2(px1, log2_cblk_w) - (px0 >> log2_cblk_w)
    nb_h = ceildivpow2(py1, log2_cblk_h) - (py0 >> log2_cblk_h)
    if px1 <= px0 or py1 <= py0:
        nb_w = nb_h = 0
    nb_w = max(nb_w, 0)
    nb_h = max(nb_h, 0)

    cblks = []
    for cblkno in range(nb_w * nb_h):
        cx0 = ((px0 >> log2_cblk_w) << log2_cblk_w) \
            + ((cblkno % nb_w) << log2_cblk_w)
        cy0 = ((py0 >> log2_cblk_h) << log2_cblk_h) \
            + ((cblkno // nb_w) << log2_cblk_h)
        cc = [[max(cx0, px0), min(cx0 + (1 << log2_cblk_w), px1)],
              [max(cy0, py0), min(cy0 + (1 << log2_cblk_h), py1)]]
        # subband coordinate shift (jpeg2000.c:364-376)
        if (bandno + (1 if reslevelno else 0)) & 1:
            d = (comp.reslevel[reslevelno - 1].coord[0][1]
                 - comp.reslevel[reslevelno - 1].coord[0][0])
            cc[0][0] += d
            cc[0][1] += d
        if (bandno + (1 if reslevelno else 0)) & 2:
            d = (comp.reslevel[reslevelno - 1].coord[1][1]
                 - comp.reslevel[reslevelno - 1].coord[1][0])
            cc[1][0] += d
            cc[1][1] += d
        cblks.append(Codeblock(coord=cc))

    return Precinct(coord=coord, nb_codeblocks_width=nb_w,
                    nb_codeblocks_height=nb_h, cblk=cblks,
                    cblkincl=TagTree(max(nb_w, 1), max(nb_h, 1)),
                    zerobits=TagTree(max(nb_w, 1), max(nb_h, 1)))


def init_component(comp_coord: list, comp_coord_o: list,
                   codsty: CodingStyle, qntsty: QuantStyle,
                   cbps: int) -> Component:
    """Build the reslevel/band/precinct/cblk tree (jpeg2000.c:469-577)."""
    if codsty.nreslevels2decode <= 0:
        raise InvalidData("nreslevels2decode invalid")

    comp = Component(coord=comp_coord, coord_o=comp_coord_o, reslevel=[])
    gbandno = 0
    for reslevelno in range(codsty.nreslevels):
        declvl = codsty.nreslevels - reslevelno
        coord = [[ceildivpow2(comp.coord_o[i][j], declvl - 1)
                  for j in range(2)] for i in range(2)]
        log2_prec_w = codsty.log2_prec_widths[reslevelno]
        log2_prec_h = codsty.log2_prec_heights[reslevelno]
        nbands = 1 if reslevelno == 0 else 3

        if coord[0][1] == coord[0][0]:
            npx = 0
        else:
            npx = ceildivpow2(coord[0][1], log2_prec_w) - (coord[0][0] >> log2_prec_w)
        if coord[1][1] == coord[1][0]:
            npy = 0
        else:
            npy = ceildivpow2(coord[1][1], log2_prec_h) - (coord[1][0] >> log2_prec_h)

        rl = ResLevel(coord=coord, log2_prec_width=log2_prec_w,
                      log2_prec_height=log2_prec_h, nbands=nbands,
                      num_precincts_x=npx, num_precincts_y=npy, band=[])
        comp.reslevel.append(rl)
        for bandno in range(nbands):
            rl.band.append(_init_band(comp, codsty, qntsty, rl,
                                      reslevelno, bandno, gbandno, cbps))
            gbandno += 1
    return comp


def init_tile(hdr: MainHeader, tileno: int) -> Tile:
    """Set up one tile's component trees (jpeg2000dec.c:1016-1070)."""
    siz = hdr.siz
    th = hdr.tiles[tileno]
    tilex = tileno % siz.num_x_tiles
    tiley = tileno // siz.num_x_tiles

    def clip(v, lo, hi):
        return min(max(v, lo), hi)

    tc = [[clip(tilex * siz.tile_width + siz.tx0, siz.x0, siz.width),
           clip((tilex + 1) * siz.tile_width + siz.tx0, siz.x0, siz.width)],
          [clip(tiley * siz.tile_height + siz.ty0, siz.y0, siz.height),
           clip((tiley + 1) * siz.tile_height + siz.ty0, siz.y0, siz.height)]]

    if len(th.codsty) != len(siz.components) or \
            len(th.qntsty) != len(siz.components):
        # styles are copied from the main header only on the TPsot==0
        # tile-part (parser._get_sot); a stream whose first tile-part is
        # missing/corrupt leaves them unset (jpeg2000dec.c guards this
        # via the zeroed tile and the !codsty->init check)
        raise InvalidData("Tile without a first tile-part (no COD/QCD)")

    comps = []
    for compno, cinfo in enumerate(siz.components):
        codsty = th.codsty[compno]
        qntsty = th.qntsty[compno]
        if not codsty.init:
            raise InvalidData("COD missing for component")
        if hdr.caps.is_ht and not hdr.caps.htrev \
                and codsty.transform == mk.DWT97:
            # jpeg2000dec.c:1056-1059: a lossy transform in a reversible-only
            # (Ccap15 bit5 = 0) HT set is invalid. The reference's +bitexact
            # mode maps the SPcod byte to DWT97_INT before this check, so
            # only the float path rejects — matched here via the parser's
            # identical mapping (parser.py:132-133).
            raise InvalidData(
                "Transformation = 0 (lossy DWT) in HTREV HT set")
        coord_o = [[ceildiv(tc[0][0], cinfo.dx), ceildiv(tc[0][1], cinfo.dx)],
                   [ceildiv(tc[1][0], cinfo.dy), ceildiv(tc[1][1], cinfo.dy)]]
        coord = [[ceildivpow2(coord_o[i][j], hdr.reduction_factor)
                  for j in range(2)] for i in range(2)]
        comp = init_component(coord, coord_o, codsty, qntsty, cinfo.depth)
        comp.roi_shift = th.roi_shift[compno] if th.roi_shift else 0
        comps.append(comp)

    return Tile(coord=tc, comp=comps, codsty=th.codsty, qntsty=th.qntsty)
