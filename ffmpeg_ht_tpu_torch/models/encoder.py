"""JPEG 2000 (T.800) encoder — capability parity with the reference encoder.

Pipeline parity: encode_frame/encode_tile (/root/reference/libavcodec/
j2kenc.c:1405-1531, 1531-1667): DC level shift -> forward DWT (5/3 or
9/7-int) -> MQ tier-1 encode with NMSEDEC distortion -> rate control
(lambda truncation or layer-rate search) -> tier-2 packet emission ->
marker/JP2 wrapping. Codestreams decode bit-exactly with both this
package's decoder and the reference `ffmpeg` decoder.

Geometry is shared with the decoder (codestream/geometry.py), so the
encoder emits exactly the grid the decoder reconstructs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from ffmpeg_ht_tpu_torch.codestream import markers as mk
from ffmpeg_ht_tpu_torch.codestream.geometry import Tile, init_tile
from ffmpeg_ht_tpu_torch.codestream.structures import (CodingStyle, ComponentInfo,
                                                 MainHeader, POCEntry,
                                                 QuantStyle, SIZ, TileHeader)
from ffmpeg_ht_tpu_torch.codestream.t2_enc import encode_packet, encode_packets
from ffmpeg_ht_tpu_torch.ops import dwt as dwtmod
from ffmpeg_ht_tpu_torch.ops import t1_enc
from ffmpeg_ht_tpu_torch.ops.t1_enc import NMSEDEC_FRACBITS

WMSEDEC_SHIFT = 13
LAMBDA_SCALE = 100000000 << (WMSEDEC_SHIFT - 13)
QP2LAMBDA = 118  # FF_QP2LAMBDA: CLI -q:v maps to quality*118

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
    jp2: bool = False            # "format" jp2 vs j2k
    tile_width: int = 256
    tile_height: int = 256
    pred: int = 1                # 1 = 5/3 reversible, 0 = 9/7-int
    sop: bool = False
    eph: bool = False
    prog: str = "lrcp"
    layer_rates: Optional[List[int]] = None
    quality: int = 0             # avctx->global_quality analog (lambda)
    nreslevels: int = 7
    log2_cblk_width: int = 4
    log2_cblk_height: int = 4
    tp_interval: int = 0   # packets per tile-part (0 = one tile-part)
    ppt: bool = False      # packed packet headers in tile header (PPT,
                           # T.800 A.7.5; beyond j2kenc — decode-path
                           # test-vector source for t2.py select_stream)
    plt: bool = False      # packet-length table in the tile header (PLT,
                           # T.800 A.7.3; varint per packet incl. SOP/EPH)
                           # — decode side skips discarded packets
                           # bytewise (t2.decode_packet plt_state)
    tlm: bool = False      # tile-part length table in the main header
                           # (TLM, T.800 A.7.1; ST=2/SP=1 records) —
                           # enables TLM random access (decode_tile)
    ppm: bool = False      # packed packet headers in MAIN header (PPM,
                           # T.800 A.7.4; one Nppm record per tile-part,
                           # requires tp_interval == 0) — decode-path
                           # test-vector source for the hdr.packed_headers
                           # distribution in t2.py:440-448
    log2_prec_width: int = 0    # user precincts (0 = maximal 2^15); HT
    log2_prec_height: int = 0   # encoder only
    ht_layers: int = 1     # HT quality layers: 2 splits Cleanup (layer 0)
                           # from SigProp+MagRef (layer 1); 3 prepends a
                           # layer of three zero-length placeholder
                           # passes (T.814 multi-layer scalability — the
                           # decoder's ht_plhd "extra length bits" branch,
                           # t2.py:303-316 / jpeg2000dec.c:1300-1318).
                           # Both need refinement=True
    ht_plhd_single: bool = False  # single-layer placeholder passes:
                           # signal npasses=6 (3 placeholders + Cleanup +
                           # SigProp + MagRef) inside ONE packet, taking
                           # the decoder's ht_plhd segment_passes=4 arm
                           # (jpeg2000dec.c:1300-1318) without multiple
                           # layers — the fast-lane (native/t2parse.c
                           # ht_plhd branch) test-vector source
    mct: bool = False      # component transform (RCT if pred=1, ICT if 0);
                           # HT encoder only (j2kenc never signals MCT)
    causal: bool = False   # vertically stripe-causal contexts (SPcod
                           # style bit 0x08, CBLK_VSC): SigProp encodes
                           # without below-stripe MBR terms — the vector
                           # source for the decoder's causal_cond path
                           # (jpeg2000htdec.c:1034-1077). Needs
                           # refinement=True to matter.
    poc: Optional[List] = None  # progression order changes (POC, T.800
                           # A.6.6): list of (rspoc, cspoc, lyepoc,
                           # repoc, cepoc, prog_str) entries, emitted as
                           # a main-header POC segment; packets are then
                           # emitted in the POC-visit order with the
                           # per-precinct dedup the decoder applies
                           # (jpeg2000dec.c:1147-1150) — the decode-side
                           # vector source for POC streams. HT encoder
                           # only
    ht_mixed: bool = False  # HT MIXED set (Ccap15 bits 14-15 = 3, SPcod
                           # style 0xC0): alternate codeblocks between the
                           # HT Cleanup coder and the legacy T.800 MQ
                           # coder — the decode-side vector source for the
                           # MIXED length state machine (t2.py:303-351 /
                           # jpeg2000dec.c:1256-1439). Requires pred=1,
                           # single layer, refinement=False
    sgnd: bool = False     # signed components (Ssiz sign bit, T.800
                           # A.5.1): input planes are int8/int16 in
                           # [-2^(B-1), 2^(B-1)-1]; no DC level shift at
                           # encode. The decoder (ours and the reference,
                           # jpeg2000dec.c:2341-2343) adds 2^(B-1)
                           # unconditionally at write_frame, so decoded
                           # output is input + 2^(B-1) as unsigned
    roi_shift: int = 0     # maxshift ROI (RGN marker, SPrgn = roi_shift;
                           # T.800 H.2 as the decoder implements it,
                           # jpeg2000dec.c:2083-2084 / htdec:1317-1331):
                           # every coefficient outside roi_rect is coded
                           # roi_shift planes below the dequant grid (the
                           # zerobits tag grows by SPrgn) and restored by
                           # the decoder's background upshift; ROI
                           # coefficients are pre-upshifted so the decoder
                           # leaves them in place. Lossless paths stay
                           # bit-exact. Requires roi_shift >= bitlength of
                           # the largest background coefficient
    origin: Tuple[int, int] = (0, 0)  # image offset (XOsiz, YOsiz) on the
                           # reference grid, tiles from (0, 0): the image
                           # spans [origin, origin + its size); a
                           # subsampled component's plane is the
                           # ceil(x / dx) grid over that span. HT encoder
                           # only
    roi_rect: Optional[tuple] = None  # (x0, y0, x1, y1) in image coords:
                           # coefficients whose subband footprint lies in
                           # the rect are ROI (kept at full precision even
                           # at truncated decode). None = everything is
                           # background (pure level-shift stream)


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
    out.extend(_be32(siz.x0) + _be32(siz.y0))  # X0Siz/Y0Siz
    out.extend(_be32(siz.tile_width) + _be32(siz.tile_height))
    out.extend(_be32(0) + _be32(0))           # XT0/YT0
    out.extend(_be16(siz.ncomponents))
    for c in siz.components:
        out.append((c.depth - 1) | (0x80 if c.sgnd else 0))
        out.append(c.dx)
        out.append(c.dy)


def _put_cod(out: bytearray, cfg: EncoderConfig, codsty: CodingStyle,
             nlayers: int) -> None:
    scod = 0
    if cfg.sop:
        scod |= mk.CSTY_SOP
    if cfg.eph:
        scod |= mk.CSTY_EPH
    out.extend(_be16(mk.COD) + _be16(12))
    out.append(scod)
    out.append(_PROG[cfg.prog])
    out.extend(_be16(nlayers))
    out.append(0)  # MCT unspecified
    out.append(codsty.nreslevels - 1)
    out.append(codsty.log2_cblk_width - 2)
    out.append(codsty.log2_cblk_height - 2)
    out.append(0)  # cblk style
    out.append(1 if codsty.transform == mk.DWT53 else 0)


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


def _cdef_box(ncomp: int) -> bytes:
    """Channel-definition box for a trailing alpha channel (JP2 I.5.3.6;
    parsed at jpeg2000dec.c cdef walk / parser.py:396-405): components
    0..ncomp-2 are colour channels associated 1..ncomp-1, the last is
    the whole-image (Asoc=0) opacity (Typ=1) channel."""
    payload = _be16(ncomp)
    for cn in range(ncomp - 1):
        payload += _be16(cn) + _be16(0) + _be16(cn + 1)
    payload += _be16(ncomp - 1) + _be16(1) + _be16(0)
    return _be32(8 + len(payload)) + b"cdef" + payload


def _jp2_wrap(codestream: bytes, siz: SIZ, colr: int) -> bytes:
    """Minimal JP2 wrapping (j2kenc.c:1557-1631)."""
    def box(tag: bytes, payload: bytes) -> bytes:
        return _be32(8 + len(payload)) + tag + payload

    sig = _be32(12) + b"jP\x20\x20" + _be32(0x0D0A870A)
    ftyp = box(b"ftyp", b"jp2\x20" + _be32(0) + b"jp2\x20")
    ihdr = box(b"ihdr", _be32(siz.height) + _be32(siz.width)
               + _be16(siz.ncomponents)
               + bytes([siz.components[0].depth, 7, 0, 0]))
    colr_box = box(b"colr", bytes([1, 0, 0]) + _be32(colr))
    jp2h = ihdr + colr_box
    if siz.ncomponents in (2, 4):
        jp2h += _cdef_box(siz.ncomponents)
    jp2h = box(b"jp2h", jp2h)
    jp2c = box(b"jp2c", codestream)
    return sig + ftyp + jp2h + jp2c


def _makelayer(tile: Tile, layno: int, thresh: float, final: bool) -> None:
    """makelayer (j2kenc.c:1168-1266): assign passes to a quality layer."""
    for comp in tile.comp:
        for rlevel in comp.reslevel:
            for band in rlevel.band:
                for prec in band.prec:
                    for cblk in prec.cblk:
                        e = cblk.enc
                        if layno == 0:
                            e.ninclpasses = 0
                        n = e.ninclpasses
                        if thresh < 0:
                            n = e.npasses
                        else:
                            for passno in range(e.ninclpasses, e.npasses):
                                p = e.passes[passno]
                                if n == 0:
                                    dr, dd = p.rate, p.disto
                                else:
                                    dr = p.rate - e.passes[n - 1].rate
                                    dd = p.disto - e.passes[n - 1].disto
                                if not dr:
                                    if dd != 0:
                                        n = passno + 1
                                    continue
                                if thresh - (dd / dr) < 2.2e-16:
                                    n = passno + 1
                        layer = e.layers[layno]
                        layer["npasses"] = n - e.ninclpasses
                        layer["cum_passes"] = n
                        if layer["npasses"] == 0:
                            layer["disto"] = 0
                            layer["data_len"] = 0
                            continue
                        if e.ninclpasses == 0:
                            layer["data_len"] = e.passes[n - 1].rate
                            layer["data_start"] = 0
                            layer["disto"] = e.passes[n - 1].disto
                        else:
                            layer["data_len"] = (e.passes[n - 1].rate
                                                 - e.passes[e.ninclpasses - 1].rate)
                            layer["data_start"] = e.passes[e.ninclpasses - 1].rate
                            layer["disto"] = (e.passes[n - 1].disto
                                              - e.passes[e.ninclpasses - 1].disto)
                        if final:
                            e.ninclpasses = n


def _makelayers(tile: Tile, cfg: EncoderConfig, nlayers: int,
                tile_layer_rates: List[float], chroma_shift) -> None:
    """Rate-targeted lambda bisection per layer (j2kenc.c:1268-1319)."""
    lo_min, hi_max = math.inf, 0.0
    for comp in tile.comp:
        for rlevel in comp.reslevel:
            for band in rlevel.band:
                for prec in band.prec:
                    for cblk in prec.cblk:
                        e = cblk.enc
                        for passno, p in enumerate(e.passes):
                            if passno == 0:
                                dr, dd = p.rate, p.disto
                            else:
                                dr = p.rate - e.passes[passno - 1].rate
                                dd = p.disto - e.passes[passno - 1].disto
                            if dr <= 0:
                                continue
                            slope = dd / dr
                            lo_min = min(lo_min, slope)
                            hi_max = max(hi_max, slope)

    prog = _PROG[cfg.prog]
    for layno in range(nlayers):
        if not tile_layer_rates[layno]:
            good = -1.0
        else:
            lo, hi = lo_min, hi_max
            stable = 0.0
            thresh = lo
            for _ in range(128):
                thresh = (lo + hi) / 2
                _makelayer(tile, layno, thresh, False)
                trial = bytearray()
                try:
                    encode_packets(trial, tile, layno + 1, prog,
                                   cfg.sop, cfg.eph, chroma_shift)
                    fits = len(trial) <= math.ceil(tile_layer_rates[layno])
                except Exception:
                    fits = False
                if not fits:
                    lo = thresh
                    continue
                hi = thresh
                stable = thresh
            good = stable if stable != 0.0 else thresh
        _makelayer(tile, layno, good, True)


def _truncpasses(tile: Tile, codsty: CodingStyle, lambda_: int) -> None:
    """Single-layer truncation by lambda (getcut/truncpasses,
    j2kenc.c:1352-1403)."""
    for comp in tile.comp:
        for reslevelno, rlevel in enumerate(comp.reslevel):
            lev = codsty.nreslevels - 1 - reslevelno
            for bandno, band in enumerate(rlevel.band):
                bandpos = bandno + (1 if reslevelno > 0 else 0)
                norm = DWT_NORMS[1 if codsty.transform == mk.DWT53 else 0]
                dwt_norm = (norm[bandpos][lev] * band.i_stepsize) >> 15
                denom = dwt_norm * dwt_norm
                lambda_prime = ((lambda_ << WMSEDEC_SHIFT) + denom // 2) // denom \
                    if denom else 0
                for prec in band.prec:
                    for cblk in prec.cblk:
                        e = cblk.enc
                        res = 0
                        for passno, p in enumerate(e.passes):
                            dr = p.rate - (e.passes[res - 1].rate if res else 0)
                            dd = p.disto - (e.passes[res - 1].disto if res else 0)
                            if dd >= dr * lambda_prime:
                                res = passno + 1
                        e.ninclpasses = res
                        e.layers[0] = {
                            "data_start": 0, "cum_passes": res, "npasses": res,
                            "data_len": e.passes[res - 1].rate if res else 0,
                            "disto": e.passes[res - 1].disto if res else 0,
                        }


def _encode_tile_components(tile: Tile, planes: List[np.ndarray],
                            codsty: CodingStyle, nlayers: int,
                            roi_s: int = 0, roi_rect=None) -> None:
    """DWT + tier-1 over one tile (encode_tile, j2kenc.c:1405-1500).

    roi_s/roi_rect: maxshift ROI (see encode_frame_htj2k) — ROI
    coefficients are pre-upshifted by roi_s before the T1 coder; the
    zerobits tag adjustment happens in encode_packet(roi=)."""
    for compno, comp in enumerate(tile.comp):
        cw = comp.coord[0][1] - comp.coord[0][0]
        ch = comp.coord[1][1] - comp.coord[1][0]
        plane = planes[compno].astype(np.int32).reshape(ch, cw)
        border = comp.coord
        plane = dwtmod.dwt_encode(plane, border, codsty.nreslevels - 1,
                                  codsty.transform)

        for reslevelno, rlevel in enumerate(comp.reslevel):
            for bandno, band in enumerate(rlevel.band):
                if (band.coord[0][0] >= band.coord[0][1]
                        or band.coord[1][0] >= band.coord[1][1]):
                    for prec in band.prec:
                        for cblk in prec.cblk:
                            cblk.enc = t1_enc.EncCblk(
                                layers=[dict(npasses=0, cum_passes=0,
                                             data_start=0, data_len=0,
                                             disto=0) for _ in range(nlayers)])
                    continue
                bandpos = bandno + (1 if reslevelno > 0 else 0)
                if codsty.transform == mk.DWT97_INT:
                    scale = (16384 * 65536) // band.i_stepsize
                for prec in band.prec:
                    for cblk in prec.cblk:
                        x0 = cblk.coord[0][0] - band.coord[0][0]
                        y0 = cblk.coord[1][0] - band.coord[1][0]
                        # cblk.coord embeds the subband interleave shift
                        # (geometry.py:216-226) => plane coords directly
                        w = cblk.width
                        h = cblk.height
                        if w <= 0 or h <= 0:
                            cblk.enc = t1_enc.EncCblk(
                                layers=[dict(npasses=0, cum_passes=0,
                                             data_start=0, data_len=0,
                                             disto=0) for _ in range(nlayers)])
                            continue
                        blk = plane[y0:y0 + h, x0:x0 + w].astype(np.int64)
                        if codsty.transform == mk.DWT53:
                            t1d = blk << NMSEDEC_FRACBITS
                        else:
                            t1d = (blk * scale) >> (15 - NMSEDEC_FRACBITS)
                        if roi_s:
                            q = np.abs(t1d)
                            if roi_rect is not None:
                                lev = (codsty.nreslevels - reslevelno) \
                                    if reslevelno \
                                    else (codsty.nreslevels - 1)
                                m = _roi_blk_mask(band, lev, roi_rect,
                                                  x0, y0, w, h)
                            else:
                                m = np.zeros(q.shape, bool)
                            bg = int(np.where(
                                m, 0, q >> NMSEDEC_FRACBITS).max()) \
                                if q.size else 0
                            if bg >= (1 << roi_s):
                                raise ValueError(
                                    f"background coefficient {bg} needs "
                                    f"roi_shift > {bg.bit_length() - 1}")
                            q = np.where(m, q << roi_s, q)
                            t1d = np.where(t1d < 0, -q, q)
                        e = t1_enc.encode_cblk(t1d, w, h, bandpos)
                        e.layers = [dict(npasses=0, cum_passes=0,
                                         data_start=0, data_len=0, disto=0)
                                    for _ in range(nlayers)]
                        cblk.enc = e


def _mixed_legacy_cblk(cblk, blk: np.ndarray, w: int, h: int,
                       bandpos: int) -> bool:
    """Code one block with the legacy T.800 MQ coder for an ht_mixed
    stream, if its length signaling survives the decoder's MIXED
    classification (t2.py:308-335 / jpeg2000dec.c:1287-1335).

    First inclusion reads lblock + av_log2(seg1) bits (seg1 = the HT
    Cleanup candidate pass count) and classifies the block as legacy only
    when that first chunk is nonzero, then widens to lblock +
    av_log2(npasses) bits — the standard legacy field.  So emission is
    byte-identical to the plain legacy form and the only constraint is
    that the total length's top chunk is nonzero:
    av_log2(L) >= av_log2(npasses) - av_log2(seg1).

    Returns False (caller encodes the block with the HT coder instead)
    when the block would be misclassified."""
    el = t1_enc.encode_cblk(blk << NMSEDEC_FRACBITS, w, h, bandpos)
    np_ = el.npasses
    if np_ <= 0:
        return False
    total = el.passes[np_ - 1].rate + len(el.passes[np_ - 1].flushed)
    if total <= 0:
        return False

    def av_log2(n: int) -> int:
        return n.bit_length() - 1 if n >= 1 else 0

    seg1 = np_ - (np_ - 1) % 3
    if av_log2(total) < av_log2(np_) - av_log2(seg1):
        return False
    el.ninclpasses = np_
    el.layers = [dict(npasses=np_, cum_passes=np_, data_start=0,
                      data_len=el.passes[np_ - 1].rate, disto=0)]
    cblk.enc = el
    return True


def _roi_blk_mask(band, lev: int, rect, cx: int, cy: int, w: int,
                  h: int) -> np.ndarray:
    """(h, w) bool: which coefficients of this codeblock are ROI.

    A coefficient at absolute band coordinate b covers image samples
    [b << lev, (b+1) << lev) along each axis; it is ROI when that
    footprint intersects `rect` (x0, y0, x1, y1). The decoder is
    agnostic to the encoder's ROI set (it classifies purely by decoded
    magnitude, jpeg2000dec.c:2083 / jpeg2000htdec.c:1326), so any
    footprint rule is conformant; intersection keeps every coefficient
    that contributes inside the rect at full precision."""
    rx0, ry0, rx1, ry1 = rect
    bx = (band.coord[0][0] + cx + np.arange(w, dtype=np.int64)) << lev
    by = (band.coord[1][0] + cy + np.arange(h, dtype=np.int64)) << lev
    mx = (bx < rx1) & (bx + (1 << lev) > rx0)
    my = (by < ry1) & (by + (1 << lev) > ry0)
    return my[:, None] & mx[None, :]


def _put_rgn(out: bytearray, ncomp: int, sprgn: int) -> None:
    """RGN markers, one per component (T.800 A.6.3; parsed by
    jpeg2000dec.c:643-672 / parser._get_rgn): Crgn, Srgn=0 (implicit
    maxshift), SPrgn."""
    for ci in range(ncomp):
        out.extend(_be16(mk.RGN) + _be16(5))
        out.append(ci)
        out.append(0)
        out.append(sprgn)


def encode_frame_htj2k(img: Union[np.ndarray, Sequence[np.ndarray]],
                       chroma_shift=(0, 0), depth: Optional[int] = None,
                       refinement: bool = False,
                       **opts) -> bytes:
    """Encode one frame as an HTJ2K (T.814) codestream.

    Capability beyond the reference (ffmpeg has no HT encoder, only the HT
    decoder); output is validated against `ffmpeg -i` in the test suite.
    Structure: SIZ (Rsiz 0x4000) + CAP/Ccap15 (HTONLY) + COD with SPcod
    cblk-style 0x40 + QCD, one cleanup-pass HT segment per codeblock
    (ops/ht_enc.py), standard T2 packet emission.

    pred=1 (default): reversible 5/3, no quantization (QSTY_NONE).
    pred=0: irreversible 9/7 (encoder-side integer DWT, the j2kenc
    convention) with scalar-expounded quantization (QSTY_SE, stepsizes per
    j2kenc.c:553-578) — the test-vector source for the lossy decode paths.
    mct=True additionally applies the component transform (RCT for pred=1,
    ICT for pred=0) across the first three equally-sized components.
    """
    from ffmpeg_ht_tpu_torch.ops import ht_enc

    cfg = EncoderConfig(**opts)
    lossy = not cfg.pred
    if cfg.ht_mixed and (lossy or refinement or cfg.ht_plhd_single):
        raise ValueError("ht_mixed requires pred=1, refinement=False, "
                         "ht_plhd_single=False")
    roi_s = cfg.roi_shift
    if roi_s and (cfg.ht_layers > 1 or cfg.ht_plhd_single):
        raise ValueError("roi_shift requires ht_layers=1 and "
                         "ht_plhd_single=False")
    if not 0 <= roi_s <= 30:
        raise ValueError("roi_shift must be in [0, 30]")

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
        cblk_style=((mk.CTSY_HTJ2K_F | mk.HT_MIXED) if cfg.ht_mixed
                    else mk.CTSY_HTJ2K_F)
        | (mk.CBLK_VSC if cfg.causal else 0), mct=1 if use_mct else 0,
        transform=mk.DWT97_INT if lossy else mk.DWT53, init=True)
    if cfg.log2_prec_width:
        codsty.log2_prec_widths = [cfg.log2_prec_width] * mk.MAX_RESLEVELS
        codsty.log2_prec_heights = ([cfg.log2_prec_height
                                     or cfg.log2_prec_width]
                                    * mk.MAX_RESLEVELS)
    nlayers_ht = cfg.ht_layers if refinement else 1
    codsty.nlayers = nlayers_ht
    qntsty = QuantStyle(nguardbits=2,
                        quantsty=mk.QSTY_SE if lossy else mk.QSTY_NONE)
    _init_quantization(codsty, qntsty, cbps)

    ox, oy = cfg.origin
    siz = SIZ(rsiz=0x4000, width=ox + width, height=oy + height, x0=ox,
              y0=oy, tile_width=cfg.tile_width, tile_height=cfg.tile_height,
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
            cx0 = -(-ox // siz.components[compno].dx)
            cy0 = -(-oy // siz.components[compno].dy)
            p = planes_in[compno][y0 - cy0:y1 - cy0,
                                  x0 - cx0:x1 - cx0].astype(np.int32)
            if not cfg.sgnd:
                # DC level shift for unsigned components only (T.800
                # G.1.2; signed input is already zero-centered)
                p = p - (1 << (cbps - 1))
            raw.append(p.reshape(ch, cw))
        if use_mct:
            from ffmpeg_ht_tpu_torch.ops import mct as mctmod
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
                    lev = (codsty.nreslevels - reslevelno) \
                        if reslevelno else (codsty.nreslevels - 1)
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
                            else:
                                q = np.abs(blk.astype(np.int64))
                            if roi_s:
                                # pre-upshift ROI coefficients so the
                                # decoder's magnitude test keeps them;
                                # everything else must fit below 2^roi_s
                                # so the background upshift restores it
                                if cfg.roi_rect is not None:
                                    m = _roi_blk_mask(
                                        band, lev, cfg.roi_rect, cx, cy,
                                        cblk.width, cblk.height)
                                else:
                                    m = np.zeros(q.shape, bool)
                                bg = int(np.where(m, 0, q).max()) \
                                    if q.size else 0
                                if bg >= (1 << roi_s):
                                    raise ValueError(
                                        f"background coefficient {bg} "
                                        f"needs roi_shift > "
                                        f"{bg.bit_length() - 1}")
                                q = np.where(m, q << roi_s, q)
                            if lossy or roi_s:
                                plane[cy:cy + cblk.height,
                                      cx:cx + cblk.width] = \
                                    np.where(blk < 0, -q,
                                             q).astype(np.int32)
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
    # HTONLY (or MIXED: bits 14-15 = 3, matching SPcod style >> 6 per the
    # reference check jpeg2000dec.c:1060-1063), single HT set, RGNFREE,
    # HOMOGENEOUS; bit5 set = irreversible transforms allowed (clear =
    # HTREV reversible-only set, which the reference rejects for
    # transform 0, jpeg2000dec.c:1056-1059)
    # bit 11: HETEROGENEOUS — required for tile-header marker segments
    # like PPT (the decoder rejects PPT in a HOMOGENEOUS HT set,
    # parser.py:626 / jpeg2000dec.c Ccap15 handling)
    # bit 12: RGN marker segments allowed in this HT set (the decoder
    # rejects RGN in an RGNFREE set, parser.py:561 / Ccap15 handling)
    ccap15 = b_field | (0x20 if lossy else 0) \
        | (0xC000 if cfg.ht_mixed else 0) \
        | (0x0800 if cfg.ppt else 0) \
        | (0x1000 if roi_s else 0)
    if roi_s and roi_s > 29 - max_magb:
        # decoded samples sit roi_s planes lower: pLSB = 30 - (zbp +
        # roi_s) must stay >= 2 for the reconstruction-half injection
        # (jpeg2000htdec.c:1276-1278, 423)
        raise ValueError(f"roi_shift {roi_s} too large for M_b "
                         f"{max_magb} (max {29 - max_magb})")
    out.extend(_be16(mk.CAP) + _be16(2 + 4 + 2))  # Lcap
    out.extend(_be32(1 << 17))  # Pcap: Ccap15 present
    out.extend(_be16(ccap15))
    _put_cod_ht(out, cfg, codsty, nlayers_ht)
    _put_qcd(out, codsty, qntsty)
    if roi_s:
        _put_rgn(out, ncomp, roi_s)
    if cfg.poc:
        # POC segment (T.800 A.6.6, 7-byte entries for <= 257 comps);
        # entries normalized exactly as the parser will read them back
        # (parser._get_poc) so the emission order below matches decode
        entries = []
        for (rspoc, cspoc, lyepoc, repoc, cepoc, prog) in cfg.poc:
            e = POCEntry(rspoc=rspoc, cspoc=cspoc, lyepoc=lyepoc,
                         repoc=repoc, cepoc=min(cepoc or 256, ncomp),
                         ppoc=_PROG[prog])
            if (e.rspoc >= e.repoc or e.repoc > 33 or e.cspoc >= e.cepoc
                    or e.lyepoc == 0):
                raise ValueError(f"invalid POC entry {e}")
            entries.append(e)
        out.extend(_be16(mk.POC) + _be16(2 + 7 * len(entries)))
        for e in entries:
            out.extend(bytes([e.rspoc, e.cspoc]) + _be16(e.lyepoc)
                       + bytes([e.repoc, e.cepoc % 256, e.ppoc]))
        for th in hdr.tiles:
            th.poc.entries = list(entries)

    if cfg.ppm and (cfg.ppt or cfg.tp_interval):
        raise ValueError("ppm needs ppt=False and tp_interval=0")
    tp_dst = bytearray() if (cfg.ppm or cfg.tlm) else out
    ppm_records: list = []
    tlm_parts: list = []

    mix_idx = 0  # ht_mixed coder alternator (included blocks only)
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
                    bandpos = bandno + (1 if reslevelno > 0 else 0)
                    for prec in band.prec:
                        for cblk in prec.cblk:
                            w, h = cblk.width, cblk.height
                            e = t1_enc.EncCblk(layers=[dict(
                                npasses=0, cum_passes=0, data_start=0,
                                data_len=0, disto=0)
                                for _ in range(nlayers_ht)])
                            cblk.enc = e
                            if w <= 0 or h <= 0:
                                continue
                            x0 = cblk.coord[0][0] - band.coord[0][0]
                            y0 = cblk.coord[1][0] - band.coord[1][0]
                            blk = plane[y0:y0 + h, x0:x0 + w].astype(np.int64)
                            if not blk.any():
                                continue
                            if cfg.ht_mixed:
                                mix_idx += 1
                                if mix_idx % 2 and _mixed_legacy_cblk(
                                        cblk, blk, w, h, bandpos):
                                    continue
                                e.mixed_ht = True
                            mag = np.abs(blk)
                            sign = (blk < 0).astype(np.int64)
                            enc3 = None
                            if refinement and magb >= 2:
                                # roi_s: the coded planes live roi_s
                                # lower (the zerobits tag grows by roi_s
                                # via encode_packet's roi param), so the
                                # entropy coder's own zbp moves with it
                                enc3 = ht_enc.encode_block_3pass(
                                    mag, sign, magb - 2 + roi_s,
                                    is_causal=int(cfg.causal))
                            if enc3 is not None:
                                # Cleanup + SigProp + MagRef (z_blk = 3)
                                data3, lcup, lref = enc3
                                e.nonzerobits = 2  # zerobits = magb - 2
                                e.npasses = 3
                                e.ninclpasses = 3
                                e.data = data3
                                e.passes = [t1_enc.Pass(rate=len(data3),
                                                        disto=0, flushed=b"")
                                            for _ in range(3)]
                                if nlayers_ht == 2:
                                    # quality-scalable split: Cleanup in
                                    # layer 0, SigProp+MagRef in layer 1.
                                    # Each layer is a single HT segment,
                                    # so the normal length coding
                                    # (lblock + av_log2(npasses)) matches
                                    # the decoder's non-initial HT branch
                                    # (t2.py:318-333)
                                    e.layers = [
                                        dict(npasses=1, cum_passes=1,
                                             data_start=0, data_len=lcup,
                                             disto=0),
                                        dict(npasses=2, cum_passes=3,
                                             data_start=lcup,
                                             data_len=lref, disto=0)]
                                elif nlayers_ht == 3:
                                    # three zero-length placeholder
                                    # passes first: the decoder counts
                                    # them into num_plhd so z_blk stays
                                    # 3, and p0 = num_plhd//3 = 1 enters
                                    # S_blk (ht_dec.py:609-628), so the
                                    # signaled zerobits drops by one to
                                    # keep pLSB identical
                                    e.nonzerobits = 3
                                    e.npasses = 6
                                    e.ninclpasses = 6
                                    e.passes = e.passes * 2
                                    e.layers = [
                                        dict(npasses=3, cum_passes=3,
                                             data_start=0, data_len=0,
                                             disto=0),
                                        dict(npasses=1, cum_passes=4,
                                             data_start=0, data_len=lcup,
                                             disto=0),
                                        dict(npasses=2, cum_passes=6,
                                             data_start=lcup,
                                             data_len=lref, disto=0)]
                                elif cfg.ht_plhd_single:
                                    # three placeholder passes folded
                                    # into the single packet: npasses=6
                                    # makes the decoder's ht_plhd arm
                                    # read a 4-pass Cleanup segment
                                    # (p0=1), so zerobits drops by one
                                    # to keep pLSB identical
                                    e.nonzerobits = 3
                                    e.npasses = 6
                                    e.ninclpasses = 6
                                    e.passes = e.passes * 2
                                    e.ht_segments = [(4, lcup), (2, lref)]
                                    e.layers = [dict(npasses=6,
                                                     cum_passes=6,
                                                     data_start=0,
                                                     data_len=len(data3),
                                                     disto=0)]
                                else:
                                    e.ht_segments = [(1, lcup), (2, lref)]
                                    e.layers = [dict(npasses=3,
                                                     cum_passes=3,
                                                     data_start=0,
                                                     data_len=len(data3),
                                                     disto=0)]
                                continue
                            dcup, lcup = ht_enc.encode_cleanup(
                                mag, sign, zbp + roi_s)
                            e.nonzerobits = magb - zbp  # zerobits tag = zbp
                            e.npasses = 1
                            e.ninclpasses = 1
                            e.data = dcup
                            e.passes = [t1_enc.Pass(rate=lcup, disto=0,
                                                    flushed=b"")]
                            if nlayers_ht == 3:
                                e.nonzerobits = magb - zbp + 1
                                e.npasses = 4
                                e.ninclpasses = 4
                                e.passes = e.passes * 4
                                e.layers = [
                                    dict(npasses=3, cum_passes=3,
                                         data_start=0, data_len=0,
                                         disto=0),
                                    dict(npasses=1, cum_passes=4,
                                         data_start=0, data_len=lcup,
                                         disto=0),
                                    dict(npasses=0, cum_passes=4,
                                         data_start=lcup, data_len=0,
                                         disto=0)]
                            else:
                                e.layers = [dict(npasses=1, cum_passes=1,
                                                 data_start=0,
                                                 data_len=lcup,
                                                 disto=0)] \
                                    + [dict(npasses=0, cum_passes=1,
                                            data_start=lcup, data_len=0,
                                            disto=0)
                                       for _ in range(nlayers_ht - 1)]

        body = bytearray()
        bnds = [] if (cfg.tp_interval or cfg.plt) else None
        hdrs = bytearray() if (cfg.ppt or cfg.ppm) else None
        if cfg.poc:
            # POC-visit order with the decoder's per-precinct dedup:
            # packet_order replays decode_tile_packets' exact iteration,
            # so emission and decode agree by construction (and both are
            # cross-validated against the reference binary in tests)
            from ffmpeg_ht_tpu_torch.codestream.t2 import packet_order
            pkno = 0
            for (compno, rlno, precno, layno) in packet_order(
                    hdr, hdr.tiles[tileno], tile, nlayers_ht):
                q = tile.qntsty[compno]
                off = 3 * rlno - 2 if rlno else 0
                encode_packet(body, tile.comp[compno].reslevel[rlno],
                              layno, precno, q.expn[off:], q.nguardbits,
                              pkno, nlayers_ht, cfg.sop, cfg.eph, hdrs,
                              roi_s)
                pkno += 1
                if bnds is not None:
                    bnds.append(len(body))
        else:
            encode_packets(body, tile, nlayers_ht, _PROG[cfg.prog],
                           cfg.sop, cfg.eph, chroma_shift, boundaries=bnds,
                           header_out=hdrs, roi=roi_s)
        if cfg.ppm:
            ppm_records.append(bytes(hdrs))
        markers = b""
        if cfg.plt:
            plens = [b - a for a, b in zip([0] + bnds[:-1], bnds)]
            markers += _plt_segments(plens)
        if cfg.ppt:
            markers += _ppt_segments(bytes(hdrs))
        _emit_tile_parts(tp_dst, tileno, bytes(body),
                         bnds if cfg.tp_interval else None,
                         cfg.tp_interval, markers,
                         part_lengths=tlm_parts if cfg.tlm else None)

    if cfg.tlm:
        out.extend(_tlm_segment(tlm_parts))
    if cfg.ppm:
        out.extend(_ppm_segments(ppm_records))
    if cfg.ppm or cfg.tlm:
        out.extend(tp_dst)
    out.extend(_be16(mk.EOC))
    if cfg.jp2:
        # JPH file format (Rec. ITU-T T.815): JP2 boxes, 'jph ' brand
        return _jph_wrap(bytes(out), siz, cbps)
    return bytes(out)


def _jph_wrap(codestream: bytes, siz: SIZ, cbps: int) -> bytes:
    """Minimal JPH wrapping (T.815: JP2 box structure, ftyp 'jph ')."""
    def box(tag: bytes, payload: bytes) -> bytes:
        return _be32(8 + len(payload)) + tag + payload

    sig = _be32(12) + b"jP\x20\x20" + _be32(0x0D0A870A)
    ftyp = box(b"ftyp", b"jph\x20" + _be32(0) + b"jph\x20")
    ihdr = box(b"ihdr", _be32(siz.height) + _be32(siz.width)
               + _be16(siz.ncomponents) + bytes([cbps, 7, 0, 0]))
    colr_code = 17 if siz.ncomponents == 1 else 16
    colr_box = box(b"colr", bytes([1, 0, 0]) + _be32(colr_code))
    jp2h = ihdr + colr_box
    if siz.ncomponents in (2, 4):
        jp2h += _cdef_box(siz.ncomponents)
    jp2h = box(b"jp2h", jp2h)
    jp2c = box(b"jp2c", codestream)
    return sig + ftyp + jp2h + jp2c



def _emit_tile_parts(out: bytearray, tileno: int, body: bytes,
                     boundaries, tp_interval: int,
                     tile_markers: bytes = b"", part_lengths=None) -> None:
    """Emit one tile's body as one or more tile-parts.

    Splits at packet boundaries only (a packet may not straddle
    tile-parts, T.800 A.4.2); TPsot/TNsot per SOT (A.4.2).
    `tile_markers` (e.g. PPT segments) go in the first tile-part header
    only (jpeg2000dec.c:995-998). `part_lengths` collects
    (tileno, total_part_bytes) per emitted part (TLM emission)."""
    cuts = [0]
    if tp_interval and boundaries:
        for i in range(tp_interval, len(boundaries), tp_interval):
            if boundaries[i - 1] not in cuts:
                cuts.append(boundaries[i - 1])
    if cuts[-1] != len(body):
        cuts.append(len(body))
    if len(cuts) - 1 > 32:
        # the reference decoder reads at most 32 tile-parts per tile
        # (jpeg2000dec.h tile_part[32]); fold the tail into part 32 so
        # every stream we emit stays reference-decodable (T.800 allows
        # 255, and our own decoder reads any count)
        cuts = cuts[:32] + [cuts[-1]]
    nparts = len(cuts) - 1
    for tp in range(nparts):
        seg = body[cuts[tp]:cuts[tp + 1]]
        markers = tile_markers if tp == 0 else b""
        psot = 12 + len(markers) + 2 + len(seg)
        out.extend(_be16(mk.SOT) + _be16(10) + _be16(tileno))
        out.extend(_be32(psot))
        out.append(tp)        # TPsot
        out.append(nparts)    # TNsot
        out.extend(markers)
        out.extend(_be16(mk.SOD))
        out.extend(seg)
        if part_lengths is not None:
            part_lengths.append((tileno, psot))


def _plt_segments(lengths) -> bytes:
    """Packet-length table (PLT, T.800 A.7.3): FF58 Lplt Zplt followed by
    one varint per packet (7 bits/byte, bit 7 = continuation), split into
    <= 65532-byte segments with Zplt ascending."""
    out = bytearray()
    chunk = bytearray()
    z = 0

    def emit_chunk():
        nonlocal z
        out.extend(_be16(mk.PLT) + _be16(3 + len(chunk))
                   + bytes([z]) + chunk)
        z += 1
        chunk.clear()

    for n in lengths:
        grp = [n & 0x7F]
        n >>= 7
        while n:
            grp.append(0x80 | (n & 0x7F))
            n >>= 7
        # never split a varint across segments (parser rejects it)
        if len(chunk) + len(grp) > 65532:
            emit_chunk()
        chunk.extend(reversed(grp))
    emit_chunk()
    return bytes(out)


def _ppt_segments(headers: bytes) -> bytes:
    """Wrap packed packet headers into PPT marker segments (T.800 A.7.5):
    FF61 Lppt Zppt <chunk>, chunks <= 65532 bytes, Zppt ascending."""
    out = bytearray()
    z = 0
    for off in range(0, max(len(headers), 1), 65532):
        chunk = headers[off:off + 65532]
        out.extend(_be16(mk.PPT) + _be16(3 + len(chunk)))
        out.append(z)
        out.extend(chunk)
        z += 1
    return bytes(out)


def _tlm_segment(parts) -> bytes:
    """TLM marker (T.800 A.7.1): Ztlm=0, Stlm ST=2/SP=1, then
    (Ttlm u16, Ptlm u32) per tile-part; chunked under the u16 Ltlm."""
    out = bytearray()
    z = 0
    per = (65535 - 4) // 6
    for off in range(0, len(parts), per):
        chunk = parts[off:off + per]
        out.extend(_be16(mk.TLM) + _be16(4 + 6 * len(chunk)))
        out.append(z)
        out.append(0x60)            # SP=1 (u32 Ptlm), ST=2 (u16 Ttlm)
        for (tno, plen) in chunk:
            out.extend(_be16(tno) + _be32(plen))
        z += 1
    return bytes(out)


def _ppm_segments(records) -> bytes:
    """Wrap per-tile-part packed headers into PPM marker segments
    (T.800 A.7.4): FF60 Lppm Zppm (Nppm u32 + headers)*, chunked at
    65532 payload bytes, Zppm ascending. The decoder re-slices the
    concatenated payload by the Nppm prefixes in SOD order
    (t2.py:440-448, jpeg2000dec.c PPM handling)."""
    payload = b"".join(_be32(len(h)) + h for h in records)
    out = bytearray()
    z = 0
    for off in range(0, max(len(payload), 1), 65532):
        chunk = payload[off:off + 65532]
        out.extend(_be16(mk.PPM) + _be16(3 + len(chunk)))
        out.append(z)
        out.extend(chunk)
        z += 1
    return bytes(out)


def _put_cod_ht(out: bytearray, cfg: EncoderConfig, codsty: CodingStyle,
                nlayers: int) -> None:
    """COD with HT codeblock style (SPcod byte 5 = 0x40)."""
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
    out.extend(_be16(nlayers))
    out.append(codsty.mct)
    out.append(codsty.nreslevels - 1)
    out.append(codsty.log2_cblk_width - 2)
    out.append(codsty.log2_cblk_height - 2)
    out.append(codsty.cblk_style)   # 0x40 HTONLY / 0xC0 MIXED
    out.append(1 if codsty.transform == mk.DWT53 else 0)
    if prec:
        for i in range(codsty.nreslevels):
            out.append(codsty.log2_prec_widths[i]
                       | (codsty.log2_prec_heights[i] << 4))


def encode_frame_t800(img: Union[np.ndarray, Sequence[np.ndarray]],
                      chroma_shift=(0, 0), depth: Optional[int] = None,
                      colr: Optional[int] = None,
                      **opts) -> bytes:
    """Encode one frame to a J2K/JP2 byte string.

    `img`: (H, W) gray, (H, W, C) interleaved, or a list of planar
    components (YUV with `chroma_shift`). Returns the full codestream.
    """
    cfg = EncoderConfig(**opts)

    if isinstance(img, np.ndarray):
        if img.ndim == 2:
            planes_in = [img]
            interleaved = False
        else:
            planes_in = [img[:, :, i] for i in range(img.shape[2])]
            interleaved = True
        height, width = img.shape[:2]
    else:
        planes_in = list(img)
        interleaved = False
        height, width = planes_in[0].shape

    ncomp = len(planes_in)
    cbps = depth or int(planes_in[0].dtype.itemsize * 8)
    if cbps == 8 and planes_in[0].dtype == np.uint16:
        cbps = 16

    codsty = CodingStyle(
        csty=(mk.CSTY_SOP if cfg.sop else 0) | (mk.CSTY_EPH if cfg.eph else 0),
        prog_order=_PROG[cfg.prog],
        nreslevels=cfg.nreslevels, nreslevels2decode=cfg.nreslevels,
        log2_cblk_width=cfg.log2_cblk_width,
        log2_cblk_height=cfg.log2_cblk_height,
        transform=mk.DWT53 if cfg.pred else mk.DWT97_INT,
        init=True)
    qntsty = QuantStyle(
        nguardbits=1,
        quantsty=mk.QSTY_NONE if cfg.pred else mk.QSTY_SE)
    _init_quantization(codsty, qntsty, cbps)

    layer_rates = cfg.layer_rates or []
    nlayers = max(1, len(layer_rates))
    codsty.nlayers = nlayers

    roi_s = cfg.roi_shift
    if roi_s:
        max_magb = max(qntsty.expn[i]
                       for i in range(codsty.nreslevels * 3 - 2)) \
            + qntsty.nguardbits - 1
        if not 0 < roi_s <= 30 - max_magb:
            # decode pass loop ends at bpno = 30 - M_b - roi_shift,
            # which must stay >= 0 (jpeg2000dec.c:2018-2021, 1997)
            raise ValueError(f"roi_shift {roi_s} out of range for M_b "
                             f"{max_magb} (max {30 - max_magb})")

    siz = SIZ(width=width, height=height,
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

    out = bytearray()
    out.extend(_be16(mk.SOC))
    _put_siz(out, siz)
    _put_cod(out, cfg, codsty, nlayers)
    _put_qcd(out, codsty, qntsty)
    if roi_s:
        _put_rgn(out, ncomp, roi_s)

    if cfg.ppm and (cfg.ppt or cfg.tp_interval):
        raise ValueError("ppm needs ppt=False and tp_interval=0")
    tp_dst = bytearray() if (cfg.ppm or cfg.tlm) else out
    ppm_records = []
    tlm_parts = []

    for tileno in range(ntiles):
        tile = init_tile(hdr, tileno)
        # DC level shift + tile crop (copy_frame_8/16, j2kenc.c:508-551)
        tplanes = []
        for compno, comp in enumerate(tile.comp):
            x0, x1 = comp.coord[0]
            y0, y1 = comp.coord[1]
            p = planes_in[compno][y0:y1, x0:x1].astype(np.int32)
            tplanes.append(p if cfg.sgnd else p - (1 << (cbps - 1)))
        _encode_tile_components(tile, tplanes, codsty, nlayers,
                                roi_s, cfg.roi_rect)

        if layer_rates:
            # bytes per layer for this tile (compute_rates, j2kenc.c:437-460)
            tlr = [0.0] * nlayers
            for compno, comp in enumerate(tile.comp):
                tw = comp.coord[0][1] - comp.coord[0][0]
                th_ = comp.coord[1][1] - comp.coord[1][0]
                scale = ((1 << chroma_shift[0]) if (compno + 1) & 2 else 1) \
                    * ((1 << chroma_shift[1]) if (compno + 1) & 2 else 1)
                for layno in range(nlayers):
                    if layer_rates[layno] > 0:
                        tlr[layno] += (tw * th_ * ncomp * cbps
                                       / (layer_rates[layno] * 8 * scale))
            _makelayers(tile, cfg, nlayers, tlr, chroma_shift)
        else:
            _truncpasses(tile, codsty, cfg.quality * QP2LAMBDA * LAMBDA_SCALE)

        body = bytearray()
        bnds = [] if (cfg.tp_interval or cfg.plt) else None
        hdrs = bytearray() if (cfg.ppt or cfg.ppm) else None
        encode_packets(body, tile, nlayers, _PROG[cfg.prog],
                       cfg.sop, cfg.eph, chroma_shift, boundaries=bnds,
                       header_out=hdrs, roi=roi_s)
        if cfg.ppm:
            ppm_records.append(bytes(hdrs))
        markers = b""
        if cfg.plt:
            plens = [b - a for a, b in zip([0] + bnds[:-1], bnds)]
            markers += _plt_segments(plens)
        if cfg.ppt:
            markers += _ppt_segments(bytes(hdrs))
        _emit_tile_parts(tp_dst, tileno, bytes(body),
                         bnds if cfg.tp_interval else None,
                         cfg.tp_interval, markers,
                         part_lengths=tlm_parts if cfg.tlm else None)

    if cfg.tlm:
        out.extend(_tlm_segment(tlm_parts))
    if cfg.ppm:
        out.extend(_ppm_segments(ppm_records))
    if cfg.ppm or cfg.tlm:
        out.extend(tp_dst)
    out.extend(_be16(mk.EOC))

    if cfg.jp2:
        if colr is None:
            colr = 17 if ncomp == 1 else (16 if interleaved else 18)
        return _jp2_wrap(bytes(out), siz, colr)
    return bytes(out)
