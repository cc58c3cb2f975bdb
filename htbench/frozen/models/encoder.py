"""HTJ2K (T.814) frame encoder: one cleanup pass a code-block.

The part of the port's ``models/encoder.py`` that ``encode_frame_htj2k``
runs without refinement passes, quality layers, ROI, POC, the MIXED set,
tile-part splits or packed headers, with its code unchanged: DC level
shift -> RCT / ICT -> forward DWT (5/3, or 9/7-int with scalar
quantization) -> HT cleanup encode (``ops/ht_enc.py``, native
``htenc.c``) -> tier-2 packets -> markers. Geometry is the decoder's
(``codestream/geometry.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Union

import numpy as np

from htbench.frozen.codestream import markers as mk
from htbench.frozen.codestream.geometry import init_tile
from htbench.frozen.codestream.structures import (CodingStyle, ComponentInfo,
                                                 MainHeader, QuantStyle, SIZ,
                                                 TileHeader)
from htbench.frozen.codestream.t2_enc import encode_packets
from htbench.frozen.ops import dwt as dwtmod
from htbench.frozen.ops.t1_enc import EncCblk, Pass

# [dwt_type][bandpos][lev] * 10000 — MSE gain of synthesis basis vectors
# (j2kenc.c:97-108; index 0 = 9/7, index 1 = 5/3)
DWT_NORMS = (
    ((10000, 19650, 41770, 84030, 169000, 338400, 676900, 1353000, 2706000, 5409000),
     (20220, 39890, 83550, 170400, 342700, 686300, 1373000, 2746000, 5490000),
     (20220, 39890, 83550, 170400, 342700, 686300, 1373000, 2746000, 5490000),
     (20800, 38650, 83070, 171800, 347100, 695900, 1393000, 2786000, 5572000)),
    ((10000, 15000, 27500, 53750, 106800, 213400, 426700, 853300, 1707000, 3413000),
     (10380, 15920, 29190, 57030, 113300, 226400, 452500, 904800, 1809000),
     (10380, 15920, 29190, 57030, 113300, 226400, 452500, 904800, 1809000),
     (7186, 9218, 15860, 30430, 60190, 120100, 240000, 479700, 959300)),
)

_PROG = {"lrcp": mk.PGOD_LRCP, "rlcp": mk.PGOD_RLCP, "rpcl": mk.PGOD_RPCL,
         "pcrl": mk.PGOD_PCRL, "cprl": mk.PGOD_CPRL}


@dataclass
class EncoderConfig:
    """Runtime options (AVOption parity, j2kenc.c:1809-1828)."""
    tile_width: int = 256
    tile_height: int = 256
    pred: int = 1                # 1 = 5/3 reversible, 0 = 9/7-int
    sop: bool = False
    eph: bool = False
    prog: str = "lrcp"
    nreslevels: int = 7
    log2_cblk_width: int = 4
    log2_cblk_height: int = 4
    log2_prec_width: int = 0    # user precincts (0 = maximal 2^15)
    log2_prec_height: int = 0
    mct: bool = False      # component transform (RCT if pred=1, ICT if 0)
    sgnd: bool = False     # signed components (Ssiz sign bit, T.800
                           # A.5.1): input planes are int8/int16 in
                           # [-2^(B-1), 2^(B-1)-1]; no DC level shift at
                           # encode


def _init_quantization(codsty: CodingStyle, qntsty: QuantStyle,
                       cbps: int) -> None:
    """init_quantization (j2kenc.c:553-578)."""
    gbandno = 0
    for reslevelno in range(codsty.nreslevels):
        lev = codsty.nreslevels - reslevelno - 1
        nbands = 3 if reslevelno else 1
        for bandno in range(nbands):
            mant = 0
            if codsty.transform == mk.DWT97_INT:
                bandpos = bandno + (1 if reslevelno > 0 else 0)
                ss = 81920000 // DWT_NORMS[0][bandpos][lev]
                log = ss.bit_length() - 1
                if 11 - log < 0:
                    mant = (ss >> (log - 11)) & 0x7FF
                else:
                    mant = (ss << (11 - log)) & 0x7FF
                expn = cbps - log + 13
            else:
                expn = ((bandno & 2) >> 1) + (1 if reslevelno > 0 else 0) + cbps
            qntsty.expn[gbandno] = expn
            qntsty.mant[gbandno] = mant
            gbandno += 1


def _be16(v: int) -> bytes:
    return v.to_bytes(2, "big")


def _be32(v: int) -> bytes:
    return v.to_bytes(4, "big")


def _put_siz(out: bytearray, siz: SIZ) -> None:
    out.extend(_be16(mk.SIZ) + _be16(38 + 3 * siz.ncomponents))
    out.extend(_be16(siz.rsiz))               # Rsiz (0x4000 for Part 15)
    out.extend(_be32(siz.width) + _be32(siz.height))
    out.extend(_be32(0) + _be32(0))           # X0Siz/Y0Siz
    out.extend(_be32(siz.tile_width) + _be32(siz.tile_height))
    out.extend(_be32(0) + _be32(0))           # XT0/YT0
    out.extend(_be16(siz.ncomponents))
    for c in siz.components:
        out.append((c.depth - 1) | (0x80 if c.sgnd else 0))
        out.append(c.dx)
        out.append(c.dy)


def _put_qcd(out: bytearray, codsty: CodingStyle, qntsty: QuantStyle) -> None:
    n = codsty.nreslevels * 3 - 2
    if qntsty.quantsty == mk.QSTY_NONE:
        size = 4 + 3 * (codsty.nreslevels - 1)
    else:
        size = 5 + 6 * (codsty.nreslevels - 1)
    out.extend(_be16(mk.QCD) + _be16(size))
    out.append((qntsty.nguardbits << 5) | qntsty.quantsty)
    if qntsty.quantsty == mk.QSTY_NONE:
        for i in range(n):
            out.append(qntsty.expn[i] << 3)
    else:
        for i in range(n):
            out.extend(_be16((qntsty.expn[i] << 11) | qntsty.mant[i]))


def _put_cod_ht(out: bytearray, cfg: EncoderConfig,
                codsty: CodingStyle) -> None:
    """COD with HT codeblock style (SPcod byte 5 = 0x40), one layer."""
    scod = 0
    if cfg.sop:
        scod |= mk.CSTY_SOP
    if cfg.eph:
        scod |= mk.CSTY_EPH
    prec = bool(codsty.csty & mk.CSTY_PREC)
    if prec:
        scod |= mk.CSTY_PREC
    out.extend(_be16(mk.COD)
               + _be16(12 + (codsty.nreslevels if prec else 0)))
    out.append(scod)
    out.append(_PROG[cfg.prog])
    out.extend(_be16(1))
    out.append(codsty.mct)
    out.append(codsty.nreslevels - 1)
    out.append(codsty.log2_cblk_width - 2)
    out.append(codsty.log2_cblk_height - 2)
    out.append(codsty.cblk_style)   # 0x40 HTONLY
    out.append(1 if codsty.transform == mk.DWT53 else 0)
    if prec:
        for i in range(codsty.nreslevels):
            out.append(codsty.log2_prec_widths[i]
                       | (codsty.log2_prec_heights[i] << 4))


def _put_tile(out: bytearray, tileno: int, body: bytes) -> None:
    """One tile as one tile-part (SOT, SOD, body; T.800 A.4.2)."""
    out.extend(_be16(mk.SOT) + _be16(10) + _be16(tileno))
    out.extend(_be32(12 + 2 + len(body)))
    out.append(0)         # TPsot
    out.append(1)         # TNsot
    out.extend(_be16(mk.SOD))
    out.extend(body)


def encode_frame_htj2k(img: Union[np.ndarray, Sequence[np.ndarray]],
                       chroma_shift=(0, 0), depth: Optional[int] = None,
                       **opts) -> bytes:
    """Encode one frame as an HTJ2K (T.814) codestream.

    Structure: SIZ (Rsiz 0x4000) + CAP/Ccap15 (HTONLY) + COD with SPcod
    cblk-style 0x40 + QCD, one cleanup-pass HT segment per codeblock
    (ops/ht_enc.py), one quality layer, standard T2 packet emission.

    pred=1 (default): reversible 5/3, no quantization (QSTY_NONE).
    pred=0: irreversible 9/7 (encoder-side integer DWT, the j2kenc
    convention) with scalar-expounded quantization (QSTY_SE, stepsizes per
    j2kenc.c:553-578).
    mct=True additionally applies the component transform (RCT for pred=1,
    ICT for pred=0) across the first three equally-sized components.
    An option of the port's encoder that this copy leaves out raises
    TypeError.
    """
    from htbench.frozen.ops import ht_enc

    cfg = EncoderConfig(**opts)
    lossy = not cfg.pred

    if isinstance(img, np.ndarray):
        planes_in = [img] if img.ndim == 2 else \
            [img[:, :, i] for i in range(img.shape[2])]
        height, width = img.shape[:2]
    else:
        planes_in = list(img)
        height, width = planes_in[0].shape

    ncomp = len(planes_in)
    cbps = depth or int(planes_in[0].dtype.itemsize * 8)

    use_mct = bool(cfg.mct) and ncomp >= 3 and chroma_shift == (0, 0)
    codsty = CodingStyle(
        csty=(mk.CSTY_SOP if cfg.sop else 0) | (mk.CSTY_EPH if cfg.eph else 0)
        | (mk.CSTY_PREC if cfg.log2_prec_width else 0),
        prog_order=_PROG[cfg.prog],
        nreslevels=cfg.nreslevels, nreslevels2decode=cfg.nreslevels,
        log2_cblk_width=cfg.log2_cblk_width,
        log2_cblk_height=cfg.log2_cblk_height,
        cblk_style=mk.CTSY_HTJ2K_F, mct=1 if use_mct else 0,
        transform=mk.DWT97_INT if lossy else mk.DWT53, init=True)
    if cfg.log2_prec_width:
        codsty.log2_prec_widths = [cfg.log2_prec_width] * mk.MAX_RESLEVELS
        codsty.log2_prec_heights = ([cfg.log2_prec_height
                                     or cfg.log2_prec_width]
                                    * mk.MAX_RESLEVELS)
    codsty.nlayers = 1
    qntsty = QuantStyle(nguardbits=2,
                        quantsty=mk.QSTY_SE if lossy else mk.QSTY_NONE)
    _init_quantization(codsty, qntsty, cbps)

    siz = SIZ(rsiz=0x4000, width=width, height=height,
              tile_width=cfg.tile_width, tile_height=cfg.tile_height,
              components=[
                  ComponentInfo(depth=cbps, sgnd=cfg.sgnd,
                                dx=(1 << chroma_shift[0]) if (i + 1) & 2 else 1,
                                dy=(1 << chroma_shift[1]) if (i + 1) & 2 else 1)
                  for i in range(ncomp)])

    hdr = MainHeader(siz=siz)
    ntiles = siz.num_x_tiles * siz.num_y_tiles
    for _ in range(ntiles):
        hdr.tiles.append(TileHeader(
            codsty=[codsty.copy() for _ in range(ncomp)],
            qntsty=[qntsty.copy() for _ in range(ncomp)],
            roi_shift=[0] * ncomp))

    # First pass: DWT every tile-component and size the guard bits so the
    # HT exponent bound U <= M_b holds for the worst coefficient: the
    # cleanup codes v = 2(|c|-1)+s whose bit length must not exceed
    # M_b = expn + nguardbits - 1 (decoder check jpeg2000htdec.c:715).
    tiles = []
    dwt_planes = []
    need_ngb = 2
    for tileno in range(ntiles):
        tile = init_tile(hdr, tileno)
        tiles.append(tile)
        raw = []
        for compno, comp in enumerate(tile.comp):
            x0, x1 = comp.coord[0]
            y0, y1 = comp.coord[1]
            cw, ch = x1 - x0, y1 - y0
            p = planes_in[compno][y0:y1, x0:x1].astype(np.int32)
            if not cfg.sgnd:
                # DC level shift for unsigned components only (T.800
                # G.1.2; signed input is already zero-centered)
                p = p - (1 << (cbps - 1))
            raw.append(p.reshape(ch, cw))
        if use_mct:
            from htbench.frozen.ops import mct as mctmod
            if lossy:
                y0_, y1_, y2_ = mctmod.ict_fwd(raw[0], raw[1], raw[2])
                raw[0] = np.rint(y0_).astype(np.int32)
                raw[1] = np.rint(y1_).astype(np.int32)
                raw[2] = np.rint(y2_).astype(np.int32)
            else:
                raw[0], raw[1], raw[2] = mctmod.rct_fwd(raw[0], raw[1],
                                                        raw[2])
        planes = []
        for compno, comp in enumerate(tile.comp):
            plane = dwtmod.dwt_encode(raw[compno], comp.coord,
                                      codsty.nreslevels - 1, codsty.transform)
            planes.append(plane)
            subbandno = 0
            for reslevelno, rlevel in enumerate(comp.reslevel):
                for bandno, band in enumerate(rlevel.band):
                    expn = qntsty.expn[subbandno]
                    subbandno += 1
                    if (band.coord[0][0] >= band.coord[0][1]
                            or band.coord[1][0] >= band.coord[1][1]):
                        continue
                    # lossy: deadzone scalar quantization, the j2kenc
                    # scaling (j2kenc.c:1463-1468) — q = (|c|*scale)>>15
                    # with scale = 2^14*2^16/i_stepsize; the decoder's
                    # dequant_int_97 reconstructs (q+0.5)*stepsize
                    scale = (16384 * 65536) // band.i_stepsize if lossy \
                        else 0
                    maxc = 0
                    for pr in band.prec:
                        for cblk in pr.cblk:
                            if cblk.width <= 0 or cblk.height <= 0:
                                continue
                            cx = cblk.coord[0][0] - band.coord[0][0]
                            cy = cblk.coord[1][0] - band.coord[1][0]
                            blk = plane[cy:cy + cblk.height,
                                        cx:cx + cblk.width]
                            if not blk.size:
                                continue
                            if lossy:
                                q = (np.abs(blk.astype(np.int64))
                                     * scale) >> 15
                                plane[cy:cy + cblk.height,
                                      cx:cx + cblk.width] = \
                                    np.where(blk < 0, -q,
                                             q).astype(np.int32)
                            else:
                                q = np.abs(blk.astype(np.int64))
                            maxc = max(maxc, int(q.max()))
                    if maxc > 1:
                        e_max = (2 * maxc - 1).bit_length()
                        need_ngb = max(need_ngb, e_max - expn + 1)
        dwt_planes.append(planes)
    if need_ngb > 7:
        raise ValueError(f"coefficients need {need_ngb} guard bits")
    qntsty.nguardbits = need_ngb
    for th in hdr.tiles:
        for q in th.qntsty:
            q.nguardbits = need_ngb

    out = bytearray()
    out.extend(_be16(mk.SOC))
    _put_siz(out, siz)
    # CAP marker: Pcap bit for Ccap15 (T.814; parsed at parser._get_cap)
    max_magb = max(qntsty.expn[i] for i in range(codsty.nreslevels * 3 - 2)) \
        + qntsty.nguardbits - 1
    b_field = max(0, max_magb - 8)
    if b_field > 19:
        raise ValueError(f"B={max_magb} not encodable in Ccap15")
    # HTONLY, single HT set, RGNFREE, HOMOGENEOUS; bit5 set = irreversible
    # transforms allowed (clear = HTREV reversible-only set, which the
    # reference rejects for transform 0, jpeg2000dec.c:1056-1059)
    ccap15 = b_field | (0x20 if lossy else 0)
    out.extend(_be16(mk.CAP) + _be16(2 + 4 + 2))  # Lcap
    out.extend(_be32(1 << 17))  # Pcap: Ccap15 present
    out.extend(_be16(ccap15))
    _put_cod_ht(out, cfg, codsty)
    _put_qcd(out, codsty, qntsty)

    for tileno in range(ntiles):
        tile = tiles[tileno]
        for compno, comp in enumerate(tile.comp):
            plane = dwt_planes[tileno][compno]
            subbandno = 0
            for reslevelno, rlevel in enumerate(comp.reslevel):
                for bandno, band in enumerate(rlevel.band):
                    magb = (qntsty.expn[subbandno] + qntsty.nguardbits - 1)
                    subbandno += 1
                    zbp = magb - 1
                    for prec in band.prec:
                        for cblk in prec.cblk:
                            w, h = cblk.width, cblk.height
                            e = EncCblk(layers=[dict(
                                npasses=0, cum_passes=0, data_start=0,
                                data_len=0, disto=0)])
                            cblk.enc = e
                            if w <= 0 or h <= 0:
                                continue
                            x0 = cblk.coord[0][0] - band.coord[0][0]
                            y0 = cblk.coord[1][0] - band.coord[1][0]
                            blk = plane[y0:y0 + h, x0:x0 + w].astype(np.int64)
                            if not blk.any():
                                continue
                            mag = np.abs(blk)
                            sign = (blk < 0).astype(np.int64)
                            dcup, lcup = ht_enc.encode_cleanup(mag, sign, zbp)
                            e.nonzerobits = magb - zbp  # zerobits tag = zbp
                            e.npasses = 1
                            e.ninclpasses = 1
                            e.data = dcup
                            e.passes = [Pass(rate=lcup, disto=0, flushed=b"")]
                            e.layers = [dict(npasses=1, cum_passes=1,
                                             data_start=0, data_len=lcup,
                                             disto=0)]

        body = bytearray()
        encode_packets(body, tile, 1, _PROG[cfg.prog], cfg.sop, cfg.eph,
                       chroma_shift)
        _put_tile(out, tileno, bytes(body))

    out.extend(_be16(mk.EOC))
    return bytes(out)
