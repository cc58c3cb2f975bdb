"""The flat fast lane's host half, and its lane arguments as tensors.

Counterpart of ``ffmpeg_ht_tpu.models.fastpath``. The host half is
copied verbatim from it (numpy and C, no framework): ``fast_profile``,
``FlatGeometry`` (with the ``_Geometry`` plan of the reference decoder),
``geometry_fingerprint``, ``parse_frame_flat`` and ``lane_raster_dims``;
``build_bucket_args`` for the v2 bucketed path. ``build_v3_frame`` keeps
the reference's lane columns but returns each lane's place in the
codestream body in place of a padded byte matrix, and ``finish_v3_numpy``
packs the word streams from the bodies in one native pass
(``native.ht_prepare_v3``). ``finish_v3_numpy`` / ``to_torch`` replace
the reference ``finish_v3``, and ``finish_buckets`` the reference
function of that name, which end in ``jnp.asarray``: the names, layouts
and bits of the returned arguments are those of the JAX functions, so
both packages can be handed identical arrays; uint32 word streams travel
as int32 tensors holding the same bits. The v3 program's arguments are
written once, into one buffer (page-locked for a card), and sent in one
copy (``Staging``); the v2 routes upload array by array; both copies go
through ``to_torch``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple  # noqa: F401

import numpy as np
import torch

from ffmpeg_ht_tpu_torch.codestream import markers as mk
from ffmpeg_ht_tpu_torch.codestream.geometry import init_tile
from ffmpeg_ht_tpu_torch.codestream.t2 import packet_order
from ffmpeg_ht_tpu_torch.utils import trace
from ffmpeg_ht_tpu_torch.utils.errors import InvalidData

_HOST_AREA = 256           # as the reference's models.decoder
# the refinement bytes a lane's densified streams hold: SigProp's prefix
# and MagRef's suffix of its Dref segment. These caps keep a malformed
# lref from blowing up the byte matrices: SigProp consumes <= 2 bits a
# sample (<= 8192), MagRef <= 1 bit a sample (<= 4096); at the worst 7
# payload bits a byte these prefixes / suffixes cover every reachable bit
SP_CAP, MR_CAP = 1200, 650


def fast_profile(hdr) -> bool:
    """Header-only check that every codeblock will fit the fast lane."""
    if hdr.has_ppm and any(len(th.tile_parts) != 1 for th in hdr.tiles):
        # multiple tile-parts share one tp_index cursor between the body
        # and PPM header streams (t2._TileStreams); the flat lane's
        # concatenated-header read is only exactly equivalent with one
        # tile-part per tile (our encoder's PPM form)
        return False
    transform = None
    for th in hdr.tiles:
        if any(r for r in th.roi_shift):
            return False
        for codsty, qntsty in zip(th.codsty, th.qntsty):
            if codsty.cblk_style != mk.CTSY_HTJ2K_F:
                return False
            if codsty.nlayers > 8 \
                    or codsty.nlayers != th.codsty[0].nlayers:
                return False
            if codsty.log2_cblk_width > 6 or codsty.log2_cblk_height > 6:
                return False
            if codsty.transform not in (mk.DWT53, mk.DWT97_INT, mk.DWT97):
                return False
            if transform is None:
                transform = codsty.transform
            elif codsty.transform != transform:
                return False
            for sb in range(codsty.nreslevels2decode * 3 - 2):
                if qntsty.expn[sb] + qntsty.nguardbits - 1 >= 31:
                    return False
    return True


@dataclass
class _Geometry:
    """Static decode plan for one codestream geometry."""
    planes: List[Tuple[int, int, int]]   # (offset, h, w) per tile-comp
    borders: Tuple                        # per tile-comp ((x0,x1),(y0,y1))
    ndecs: Tuple                          # per tile-comp declevels
    mct: Tuple                            # per tile bool
    tile_comp_index: List[List[int]]      # tileno -> [plane indices]
    cbps: int
    total: int
    transform: int = mk.DWT53             # uniform across the frame

    def key(self) -> Tuple:
        return (tuple(self.planes), tuple(self.borders), tuple(self.ndecs),
                tuple(self.mct),
                tuple(tuple(i) for i in self.tile_comp_index),
                self.cbps, self.total, self.transform)


class FlatGeometry:
    """Per-geometry static plan (cached across frames)."""

    __slots__ = ("tiles", "geom", "w", "h", "dest", "stride",
                 "magb", "istep", "scale97", "fscale", "fstep", "ncblks",
                 "tile_pkts", "tile_range", "area_small", "prec_list",
                 "v3_plan", "v3_progs")

    def __init__(self, hdr):
        from ffmpeg_ht_tpu_torch.ops.dequant import int97_scale

        tiles = []
        for tileno in range(len(hdr.tiles)):
            tiles.append(init_tile(hdr, tileno))
        self.tiles = tiles

        transform = tiles[0].codsty[0].transform if tiles else mk.DWT53

        planes = []
        borders = []
        ndecs = []
        tci = []
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
            tci.append(idxs)

        self.geom = _Geometry(
            planes=planes, borders=tuple(borders), ndecs=tuple(ndecs),
            mct=tuple(bool(t.codsty[0].mct) for t in tiles),
            tile_comp_index=tci, cbps=hdr.siz.components[0].depth,
            total=offset, transform=transform)

        # flat per-cblk geometry in (tile, comp, reslevel, band, precinct,
        # cblk) order — the same order _build_batch walks
        cols: Dict[str, List] = {k: [] for k in (
            "w", "h", "dest", "stride", "magb", "istep", "scale97",
            "fscale", "fstep")}
        # v3 assembly-plan raw material: one entry per precinct instance,
        # (abs_lane_start, ch, cw, plane_idx, tileno, compno, rlno, bandno)
        self.prec_list = []
        self.v3_plan = None        # built lazily by models.assembly
        self.v3_progs = {}         # (F, ms_class, no_istep, layout,
                                   #  wire_pack) -> V3Program
        # per-tile: packet metadata for the native parser
        self.tile_pkts = []
        self.tile_range = []
        # per (tile, comp, reslevel, precno) -> list of band instances
        for tileno, tile in enumerate(tiles):
            cblk_base = len(cols["w"])
            prec_map = {}
            tree_count = 0
            # lowres: packets of reslevels >= nreslevels2decode still
            # occupy the stream, so the native parser must walk them
            # (tag trees and all); their codeblocks land in a discard
            # zone after the tile's kept codeblocks (negative base
            # markers resolved below) and never reach cols/prec_list —
            # the parse advances, the coefficients are dropped
            # (ref: jpeg2000dec.c:509-520 reslevels2decode)
            dropped = 0
            for compno, comp in enumerate(tile.comp):
                qntsty = tile.qntsty[compno]
                nres2dec = tile.codsty[compno].nreslevels2decode
                poff = planes[tci[tileno][compno]][0]
                pstride = planes[tci[tileno][compno]][2]
                subbandno = 0
                for rlno, rl in enumerate(comp.reslevel):
                    for bandno, band in enumerate(rl.band):
                        magb = qntsty.expn[subbandno] \
                            + qntsty.nguardbits - 1
                        subbandno += 1
                        if (band.coord[0][0] >= band.coord[0][1]
                                or band.coord[1][0] >= band.coord[1][1]):
                            continue
                        if rlno >= nres2dec:
                            for precno, prec in enumerate(band.prec):
                                cw = prec.nb_codeblocks_width
                                ch = prec.nb_codeblocks_height
                                prec_map.setdefault(
                                    (compno, rlno, precno), []).append(
                                    (-(dropped + 1), cw, ch, magb,
                                     tree_count))
                                tree_count += 1
                                dropped += cw * ch
                            continue
                        s97 = int97_scale(band.f_stepsize, magb) \
                            if transform == mk.DWT97_INT else 0
                        fsc = float(np.float32(band.f_stepsize)
                                    / np.float32(1 << (31 - magb))) \
                            if transform == mk.DWT97 else 0.0
                        for precno, prec in enumerate(band.prec):
                            # tile-relative: the native parser indexes
                            # its outputs from this tile's first cblk
                            base = len(cols["w"]) - cblk_base
                            cw = prec.nb_codeblocks_width
                            ch = prec.nb_codeblocks_height
                            prec_map.setdefault(
                                (compno, rlno, precno), []).append(
                                (base, cw, ch, magb, tree_count))
                            tree_count += 1
                            self.prec_list.append(
                                (len(cols["w"]), ch, cw,
                                 tci[tileno][compno], tileno, compno,
                                 rlno, bandno))
                            for cblk in prec.cblk:
                                x = cblk.coord[0][0] - band.coord[0][0]
                                y = cblk.coord[1][0] - band.coord[1][0]
                                cols["w"].append(cblk.width)
                                cols["h"].append(cblk.height)
                                cols["dest"].append(
                                    poff + y * pstride + x)
                                cols["stride"].append(pstride)
                                cols["magb"].append(magb)
                                cols["istep"].append(band.i_stepsize)
                                cols["scale97"].append(s97)
                                cols["fscale"].append(fsc)
                                cols["fstep"].append(
                                    float(band.f_stepsize))
            # packets in stream order (all quality layers)
            th = hdr.tiles[tileno]
            nlayers = th.codsty[0].nlayers
            order = packet_order(hdr, th, tile, nlayers)
            pkt_nband, pkt_csty, pkt_style, pkt_layno = [], [], [], []
            bi_base, bi_cw, bi_ch, bi_magb, bi_tree = [], [], [], [], []
            kept_n = len(cols["w"]) - cblk_base
            for (compno, rlno, precno, layno) in order:
                bis = prec_map.get((compno, rlno, precno), [])
                pkt_nband.append(len(bis))
                pkt_csty.append(th.codsty[compno].csty)
                pkt_style.append(th.codsty[compno].cblk_style)
                pkt_layno.append(layno)
                for (base, cw, ch, magb, tid) in bis:
                    # negative = lowres discard zone after the kept cblks
                    bi_base.append(base if base >= 0
                                   else kept_n + (-base - 1))
                    bi_cw.append(cw)
                    bi_ch.append(ch)
                    bi_magb.append(magb)
                    bi_tree.append(tid)
            self.tile_pkts.append((
                np.asarray(pkt_nband, np.int32),
                np.asarray(pkt_csty, np.int32),
                np.asarray(pkt_style, np.int32),
                np.asarray(pkt_layno, np.int32),
                np.asarray(bi_base, np.int32),
                np.asarray(bi_cw, np.int32),
                np.asarray(bi_ch, np.int32),
                np.asarray(bi_magb, np.int32),
                np.asarray(bi_tree, np.int32),
                tree_count, nlayers, kept_n + dropped))
            self.tile_range.append((cblk_base, len(cols["w"])))

        for k in ("w", "h", "dest", "stride", "magb", "istep", "scale97"):
            setattr(self, k, np.asarray(cols[k], np.int64))
        self.fscale = np.asarray(cols["fscale"], np.float64)
        self.fstep = np.asarray(cols["fstep"], np.float64)
        self.ncblks = len(cols["w"])
        self.area_small = (self.w * self.h) < _HOST_AREA


def geometry_fingerprint(hdr):
    """Hashable key over every header field the flat geometry reads."""
    siz = hdr.siz
    key = [siz.width, siz.height, siz.x0, siz.y0, siz.tile_width,
           siz.tile_height, siz.tx0, siz.ty0,
           hdr.reduction_factor,
           tuple((c.depth, c.sgnd, c.dx, c.dy) for c in siz.components)]
    for th in hdr.tiles:
        # POC rewrites the packet order baked into tile_pkts
        key.append(tuple((e.rspoc, e.cspoc, e.lyepoc, e.repoc, e.cepoc,
                          e.ppoc) for e in th.poc.entries))
        for codsty, qntsty in zip(th.codsty, th.qntsty):
            key.append((codsty.csty, codsty.prog_order, codsty.nlayers,
                        codsty.nreslevels, codsty.nreslevels2decode,
                        codsty.log2_cblk_width, codsty.log2_cblk_height,
                        codsty.cblk_style, codsty.transform, codsty.mct,
                        tuple(codsty.log2_prec_widths),
                        tuple(codsty.log2_prec_heights)))
            key.append((qntsty.quantsty, qntsty.nguardbits,
                        tuple(qntsty.expn), tuple(qntsty.mant)))
    return tuple(map(lambda v: tuple(v) if isinstance(v, list) else v, key))


@trace.timed("parse")
def parse_frame_flat(hdr, fg: FlatGeometry) -> Optional[dict]:
    """Native T2 parse of every tile into flat per-cblk columns.

    Returns dict(body, off, len, lcup, lref, zbp, npasses, incl) with
    body a single contiguous bytes-like buffer (each codeblock's segments
    gathered across quality layers), or None if the native tier is
    unavailable or a packet leaves the supported profile."""
    from ffmpeg_ht_tpu_torch.utils import native

    bodies = []
    outs = []
    base_off = 0
    multilayer = False
    if hdr.has_ppm:
        from ffmpeg_ht_tpu_torch.codestream.t2 import distribute_ppm_headers
        distribute_ppm_headers(hdr)
    for tileno, th in enumerate(hdr.tiles):
        parts = sorted(th.tile_parts, key=lambda tp: tp.tp_index)
        body = b"".join(bytes(tp.data) for tp in parts)
        # packed packet headers (PPM: per-tile-part slices, gated to one
        # part per tile; PPT: the tile's accumulated buffer)
        pph = None
        if hdr.has_ppm:
            pph = b"".join(bytes(tp.ppm_header or b"") for tp in parts)
        elif th.has_ppt:
            pph = bytes(th.packed_headers)
        (pkt_nband, pkt_csty, pkt_style, pkt_layno,
         bi_base, bi_cw, bi_ch, bi_magb, bi_tree,
         n_trees, nlayers, n_parse) = fg.tile_pkts[tileno]
        lo, hi = fg.tile_range[tileno]
        o = native.t2_parse_packets(body, pkt_nband, pkt_csty, pkt_style,
                                    pkt_layno, bi_base, bi_cw, bi_ch,
                                    bi_magb, bi_tree, n_trees, 0,
                                    n_parse, max(nlayers, 1), pph=pph)
        if o is None:
            return None
        if n_parse > hi - lo:       # lowres: drop the discard zone
            o = {k: v[:hi - lo] for k, v in o.items()}
        o["seg_off"] = o["seg_off"] + base_off
        multilayer = multilayer or nlayers > 1
        bodies.append(body)
        outs.append(o)
        base_off += len(body)

    cols = {k: np.concatenate([o[k] for o in outs]) if len(outs) > 1
            else outs[0][k]
            for k in ("incl", "zbp", "nzb", "npasses", "lcup", "lref",
                      "len", "nseg")}
    full = bodies[0] if len(bodies) == 1 else b"".join(bodies)
    seg_off = np.concatenate([o["seg_off"] for o in outs]) \
        if len(outs) > 1 else outs[0]["seg_off"]
    seg_len = np.concatenate([o["seg_len"] for o in outs]) \
        if len(outs) > 1 else outs[0]["seg_len"]

    if not multilayer or int(cols["nseg"].max(initial=0)) <= 1:
        cols["off"] = seg_off[:, 0].copy()
        cols["body"] = full
    else:
        # gather each codeblock's per-layer segments into one contiguous
        # run — pure data movement, native memcpy loop (seggather.c;
        # the vectorized numpy fallback below cost ~580 ms on an 8K
        # 2-layer frame against ~3 ms native)
        tot = cols["len"]
        N = len(tot)
        new_off = np.zeros(N, np.int64)
        np.cumsum(tot[:-1], out=new_off[1:])
        buf = np.frombuffer(full, np.uint8)
        out = native.seg_gather(buf, seg_off, seg_len, cols["nseg"],
                                new_off, int(tot.sum()))
        if out is not None:
            cols["off"] = new_off
            cols["body"] = out.tobytes()
            return _finish_cols(cols)
        out_body = np.zeros(int(tot.sum()), np.uint8)
        cum = np.cumsum(seg_len, axis=1)               # (N, S)
        prev = np.concatenate(
            [np.zeros((N, 1), np.int64), cum[:, :-1]], axis=1)
        step = max(1, (1 << 24) // max(int(tot.max(initial=1)), 1))
        for c0 in range(0, N, step):
            c1 = min(c0 + step, N)
            t = tot[c0:c1]
            lmax = int(t.max(initial=1))
            pos = np.arange(lmax)[None, :]
            seg_id = np.zeros((c1 - c0, lmax), np.int64)
            for s in range(seg_len.shape[1] - 1):
                seg_id += (cum[c0:c1, s:s + 1] <= pos)
            src = (np.take_along_axis(seg_off[c0:c1], seg_id, axis=1)
                   + pos
                   - np.take_along_axis(prev[c0:c1], seg_id, axis=1))
            valid = pos < t[:, None]
            vals = buf[np.minimum(np.where(valid, src, 0),
                                  len(buf) - 1)]
            dst = new_off[c0:c1, None] + pos
            out_body[dst[valid]] = vals[valid]
        cols["off"] = new_off
        cols["body"] = out_body.tobytes()

    return _finish_cols(cols)


def _finish_cols(cols: dict) -> dict:
    # error parity with the object path (_build_batch raises on lcup < 2
    # for any included codeblock; ht_dec.py:618-619)
    inc = cols["incl"].astype(bool) & (cols["npasses"] > 0)
    if np.any(inc & (cols["lcup"] < 2)):
        raise InvalidData("cleanup pass length < 2")
    cols["active"] = inc
    return cols


@trace.timed("lane_cols")
def build_bucket_args(fg: FlatGeometry, cols: dict, dest_shift=0,
                      prev=None):
    """Array-level replacement of _build_batch.

    Returns (accum) where accum collects per-bucket lane columns across
    frames (decode_batch merges by calling repeatedly with dest_shift);
    finish_buckets() turns it into the (shapes, bucket_args, pf) triple
    _dispatch_args consumes.
    """
    body = np.frombuffer(cols["body"], np.uint8)
    act = cols["active"]
    idx = np.nonzero(act)[0]
    if len(idx) == 0 and prev is None:
        prev = {"buckets": {}, "pf_idx": [], "pf_val": [], "fg": fg}
        return prev

    zbp = cols["zbp"][idx]
    npasses = cols["npasses"][idx]
    lcup = cols["lcup"][idx]
    lref = cols["lref"][idx]
    off = cols["off"][idx]
    w = fg.w[idx]
    h = fg.h[idx]

    # z_blk from npasses (ht_dec.py:609-612); placeholder passes shift
    # the bitplane: S_blk = p0 + zbp (ht_dec.py:611,627). zbp_eff is the
    # device-lane view (pLSB/maxbp math); the host oracle takes the RAW
    # zbp because decode_htj2k re-derives p0 from npasses itself.
    rem = npasses % 3
    plhd = np.where(rem, npasses - rem, npasses - 3)
    zblk = npasses - plhd
    zbp_eff = zbp + plhd // 3

    # host-oracle lanes: edge slivers and extreme bitplanes
    host = fg.area_small[idx] | (zbp_eff + 1 > 25)
    accum = prev if prev is not None else {
        "buckets": {}, "pf_idx": [], "pf_val": [], "fg": fg}

    if np.any(host):
        from ffmpeg_ht_tpu_torch.ops import dequant as dq
        from ffmpeg_ht_tpu_torch.ops import ht_dec
        tf = fg.geom.transform
        trace.count("oracle_lanes", int(host.sum()))
        with trace.span("oracle"):
            for k in np.nonzero(host)[0]:
                gi = idx[k]
                data = cols["body"][off[k]:off[k] + cols["len"][gi]]
                t1 = ht_dec.decode_htj2k(
                    bytes(data), int(npasses[k]), int(cols["zbp"][gi]),
                    [int(lcup[k]), int(lref[k])], int(w[k]), int(h[k]),
                    int(fg.magb[gi]), 0, 0)
                if tf == mk.DWT97:
                    blk = dq.dequant_float(
                        t1, float(fg.fstep[gi]), int(fg.magb[gi]))
                elif tf == mk.DWT97_INT:
                    blk = dq.dequant_int_97(
                        t1, float(fg.fstep[gi]), int(fg.magb[gi]))
                else:
                    blk = dq.dequant_int(t1, int(fg.istep[gi]),
                                         int(fg.magb[gi]))
                base = int(fg.dest[gi]) + dest_shift
                stride = int(fg.stride[gi])
                rows = base + np.arange(int(h[k]))[:, None] * stride \
                    + np.arange(int(w[k]))[None, :]
                accum["pf_idx"].append(rows.ravel())
                accum["pf_val"].append(np.asarray(blk).ravel())

    dev = ~host
    di = idx[dev]
    if len(di) == 0:
        return accum
    w, h = fg.w[di], fg.h[di]
    lcup, lref = cols["lcup"][di], cols["lref"][di]
    off = cols["off"][di]
    zbp = zbp_eff[dev]
    zblk = zblk[dev]

    # Scup from the last two cleanup bytes (vectorized; error parity with
    # _build_batch / jpeg2000htdec.c:1265-1273)
    b_last = body[off + lcup - 1].astype(np.int64)
    b_prev = body[off + lcup - 2].astype(np.int64)
    scup = (b_last << 4) + (b_prev & 0x0F)
    if np.any((scup < 2) | (scup > lcup) | (scup > 4079)):
        raise InvalidData("invalid Scup")

    # length class (same pow2 rule as _build_batch)
    need = (8 * lcup + 96) // 32
    wc = np.maximum(16, 1 << np.ceil(np.log2(np.maximum(need, 1))
                                     ).astype(np.int64))
    keycode = (w.astype(np.int64) << 40) | (h.astype(np.int64) << 24) | wc
    uniq, inv = np.unique(keycode, return_inverse=True)
    for u_i, u in enumerate(uniq):
        lane_sel = inv == u_i
        li = di[lane_sel]
        b = accum["buckets"].setdefault(
            (int(u >> 40), int((u >> 24) & 0xFFFF), int(u & 0xFFFFFF)),
            {"rows": [], "gi": [], "pcup": [], "zbp": [], "dest": []})
        b["rows"].append((cols["body"], off[lane_sel], lcup[lane_sel],
                          lref[lane_sel], zblk[lane_sel]))
        b["gi"].append(li)
        b["pcup"].append(lcup[lane_sel] - scup[lane_sel])
        b["zbp"].append(zbp[lane_sel])
        b["dest"].append(fg.dest[li] + dest_shift)
    return accum


@trace.timed("lane_args")
def finish_buckets(accum, total):
    """(shapes, bucket_args, pf_idx, pf_val) for decoder._dispatch_args,
    as numpy arrays (``to_torch`` uploads them): the reference
    ``finish_buckets`` without its ``jnp.asarray``, each bucket packed by
    ``pack_bucket`` with modDcup on every row, its pad rows included."""
    fg = accum["fg"]
    shapes, bucket_args = [], []
    for key in sorted(accum["buckets"].keys()):
        b = accum["buckets"][key]
        gi = np.concatenate(b["gi"])
        shape, args = pack_bucket(key[:2], b["rows"], dict(
            pcup=np.concatenate(b["pcup"]), zbp=np.concatenate(b["zbp"]),
            magb=fg.magb[gi], istep=fg.istep[gi], scale97=fg.scale97[gi],
            fscale=fg.fscale[gi], dest=np.concatenate(b["dest"]),
            stride=fg.stride[gi],
            # fast_profile admits CTSY_HTJ2K_F only, never VSC
            causal=np.zeros(len(gi), bool)), moddcup=True)
        shapes.append(shape)
        bucket_args.append(args)

    if accum["pf_idx"]:
        pf_idx = np.concatenate(accum["pf_idx"]).astype(np.int32)
        pf_val = np.concatenate(accum["pf_val"])
    else:
        pf_idx = np.array([total], np.int32)
        dt = np.float32 if fg.geom.transform == mk.DWT97 else np.int32
        pf_val = np.zeros(1, dt)
    return shapes, bucket_args, pf_idx, pf_val


def pack_bucket(wh, rows, lanes, moddcup: bool):
    """One BucketProgram bucket of w x h codeblocks: (its shape, its
    argument dict), the arrays the JAX package's ``finish_buckets`` and
    ``_bucket_arrays`` give, key for key and bit for bit.

    rows: (body, off, lcup, lref, zblk) tuples, each for the lanes that
    read one body: lane i's cleanup segment is ``body[off[i]:][:lcup[i]]``
    and its Dref segment the lref[i] bytes after it (0 past the body's
    end). lanes: the per-lane columns in row order (pcup, zbp, magb,
    istep, scale97, fscale, dest, stride, causal). The cleanup words come
    from one ``native.ht_prepare_v3`` pass, a pad lane reading an empty
    body with lcup 2 and pcup 0; `moddcup` applies modDcup to every row,
    pads included (the flat lane), or to none (the object path, whose
    rows carry it)."""
    from ffmpeg_ht_tpu_torch.models import decoder as D
    from ffmpeg_ht_tpu_torch.ops.ht_batch import (prepare_magref_stream,
                                                  prepare_sigprop_stream)
    from ffmpeg_ht_tpu_torch.utils import native
    bodies = [np.frombuffer(r[0], np.uint8) for r in rows]
    counts = [len(r[1]) for r in rows]
    off, lcup, lref, zblk = (
        np.concatenate([np.asarray(r[k], np.int64) for r in rows])
        for k in (1, 2, 3, 4))
    n = len(off)
    npad = D._pow2(n, D._LANE_PAD)
    msw, melw, vlcw, ms_lim, mel_lim = native.ht_prepare_v3(
        bodies + [np.zeros(0, np.uint8)], _pad(off, npad, 0),
        _pad(lcup, npad, 2), _pad(lanes["pcup"], npad, 0),
        np.full(npad, moddcup), counts=counts + [npad - n])

    real = np.arange(npad) < n
    zbp = np.asarray(lanes["zbp"], np.int64)
    args = dict(
        msw=msw, melw=melw, vlcw=vlcw, ms_lim=ms_lim, mel_lim=mel_lim,
        pLSB=np.where(real, 30 - _pad(zbp, npad, 0), 2).astype(np.int32),
        maxbp=np.where(real, _pad(zbp, npad, 31) + 1, 32).astype(np.int32),
        magb=_pad(lanes["magb"], npad, 8).astype(np.int32),
        istep=_pad(lanes["istep"], npad, 32768).astype(np.int32),
        scale97=_pad(lanes["scale97"], npad, 0).astype(np.int32),
        fscale=_pad(lanes["fscale"], npad, 0.0).astype(np.float32),
        dest=_pad(lanes["dest"], npad, -1).astype(np.int32),   # trash slot
        stride=_pad(lanes["stride"], npad, 0).astype(np.int32),
        nreal=n,
    )
    refined = bool((zblk > 1).any())
    if refined:
        # SigProp reads a prefix and MagRef a suffix of the Dref segment,
        # capped at SP_CAP / MR_CAP bytes; bytes past the body's end (a
        # truncated stream) read as zeros, left-aligned
        dref = np.nonzero((zblk > 1) & (lref > 0))[0]
        lsp = _pad(np.where(zblk > 1, np.minimum(lref, SP_CAP), 0), npad, 0)
        lmr = _pad(np.where(zblk > 1, np.minimum(lref, MR_CAP), 0), npad, 0)
        dsp = np.zeros((npad, max(int(lsp.max()), 4)), np.uint8)
        dmr = np.zeros((npad, max(int(lmr.max()), 4)), np.uint8)
        body_of = np.repeat(np.arange(len(rows)), counts)
        for r in dref:
            body, o, lr = bodies[body_of[r]], off[r] + lcup[r], lref[r]
            seg = body[o:o + lsp[r]]
            dsp[r, :len(seg)] = seg
            seg = body[o + max(lr - MR_CAP, 0):o + lr]
            dmr[r, :len(seg)] = seg
        args.update(
            spw=prepare_sigprop_stream(dsp, lsp),
            mrw=prepare_magref_stream(dmr, lmr),
            has_sp=_pad(zblk >= 2, npad, False),
            has_mr=_pad(zblk >= 3, npad, False),
            causal=_pad(lanes["causal"], npad, 0).astype(bool))
    mb = int(zbp.max()) + 1          # the MagSgn class bounds every lane
    ms_class = next(c for c in (8, 12, 16, 20, 25) if mb <= c)
    w, h = wh
    return (-(-w // 2), -(-h // 2), w, h, ms_class, refined), args


def _pad(a, npad, fill):
    out = np.full(npad, fill, np.asarray(a).dtype
                  if np.asarray(a).dtype != np.float64 else np.float64)
    out[:len(a)] = a
    return out


def lane_raster_dims(fg):
    """(bh, bw) of the merged-bucket lane raster — the per-lane (2qh, 2qw)
    plane the entropy kernel emits. Must match assembly.build_plan."""
    bw = 2 * (-(-int(fg.w.max()) // 2)) if fg.ncblks else 2
    bh = 2 * (-(-int(fg.h.max()) // 2)) if fg.ncblks else 2
    return bh, bw


@trace.timed("lane_cols")
def build_v3_frame(fg, cols):
    """Per-frame v3 lane columns, or None if the frame needs v2.

    Returns dict(body, off, dev, lcups, pcups, qws, qhs, pLSB, maxbp,
    host_pf): lane i reads ``body[off[i] + j]`` for j < lcups[i] (0 past
    the body's end), with modDcup on the device lanes (`dev`); host and
    inert lanes read two bytes as they are. host_pf is a list of (idx,
    values) numpy pairs from the scalar-oracle fallback lanes, indexed in
    LANE-RASTER coordinates (gi * bh * bw + y * bw + x): the fused program
    scatters them into the dequantized lane rasters before the band
    mosaics, so host lanes ride the same scatter-free assembly as device
    lanes. ``finish_v3_numpy`` packs the lanes' word streams."""
    body = np.frombuffer(cols["body"], np.uint8)
    act = cols["active"]
    npasses = np.where(act, cols["npasses"], 0)
    rem = npasses % 3
    plhd = np.where(rem, npasses - rem,
                    np.maximum(npasses - 3, 0))
    zblk = npasses - plhd
    zbp_eff = cols["zbp"] + plhd // 3
    if np.any(act & (zblk > 1)):
        return None                     # refinement lanes: v2 path

    lcup = np.where(act, cols["lcup"], 2)
    need = (8 * lcup + 96) // 32
    host = act & (zbp_eff + 1 > 25)
    dev = act & ~host
    if np.any(dev):
        # long-tail policy: keep the stream matrix narrow by sending the
        # rare outlier-length codeblocks to the scalar oracle
        w98 = int(np.percentile(need[dev], 98))
        wcap = 16
        while wcap < w98:
            wcap *= 2
        wmax = int(need[dev].max())
        if wmax > 2 * wcap:
            host = host | (act & (need > wcap))
            dev = act & ~host

    lcups = np.where(dev, lcup, 2).astype(np.int64)
    off = np.asarray(cols["off"], np.int64)
    # Scup from each lane's last two bytes (parity jpeg2000htdec.c:1265-1278)
    b_last = _bytes_at(body, off + lcups - 1)
    b_prev = _bytes_at(body, off + lcups - 2)
    scup = (b_last << 4) + (b_prev & 0x0F)
    if np.any(dev & ((scup < 2) | (scup > lcups) | (scup > 4079))):
        raise InvalidData("invalid Scup")
    pcups = np.where(dev, lcups - scup, 0).astype(np.int64)

    qws = np.where(dev, -(-fg.w // 2), 0).astype(np.int32)
    qhs = np.where(dev, -(-fg.h // 2), 0).astype(np.int32)
    pLSB = np.where(dev, 30 - zbp_eff, 2).astype(np.int32)
    maxbp = np.where(dev, zbp_eff + 1, 32).astype(np.int32)

    host_pf = []
    if np.any(host):
        from ffmpeg_ht_tpu_torch.ops import dequant as dq
        from ffmpeg_ht_tpu_torch.ops import ht_dec
        tf = fg.geom.transform
        bh, bw = lane_raster_dims(fg)
        trace.count("oracle_lanes", int(host.sum()))
        with trace.span("oracle"):
            for gi in np.nonzero(host)[0]:
                dat = cols["body"][cols["off"][gi]:
                                   cols["off"][gi] + cols["len"][gi]]
                t1 = ht_dec.decode_htj2k(
                    bytes(dat), int(cols["npasses"][gi]),
                    int(cols["zbp"][gi]),
                    [int(cols["lcup"][gi]), int(cols["lref"][gi])],
                    int(fg.w[gi]), int(fg.h[gi]), int(fg.magb[gi]), 0, 0)
                if tf == mk.DWT97:
                    blk = dq.dequant_float(t1, float(fg.fstep[gi]),
                                           int(fg.magb[gi]))
                elif tf == mk.DWT97_INT:
                    blk = dq.dequant_int_97(t1, float(fg.fstep[gi]),
                                            int(fg.magb[gi]))
                else:
                    blk = dq.dequant_int(t1, int(fg.istep[gi]),
                                         int(fg.magb[gi]))
                rows = (int(gi) * (bh * bw)
                        + np.arange(int(fg.h[gi]))[:, None] * bw
                        + np.arange(int(fg.w[gi]))[None, :])
                host_pf.append((rows.ravel(), np.asarray(blk).ravel()))
    return dict(body=body, off=off, dev=dev, lcups=lcups, pcups=pcups,
                qws=qws, qhs=qhs, pLSB=pLSB, maxbp=maxbp, host_pf=host_pf)


def _bytes_at(body, pos):
    """body[pos] as int64, 0 at or past the body's end."""
    out = np.zeros(len(pos), np.int64)
    inside = pos < len(body)
    out[inside] = body[pos[inside]]
    return out


@trace.timed("lane_args")
def finish_v3_numpy(fg, frames_cols, total, alloc=None):
    """Pack per-frame ``build_v3_frame`` columns into the v3 program's
    arguments as numpy arrays (JAX dtypes: uint32 streams, int32 vectors,
    float32 fscale): one native pass from the frames' bodies to the word
    streams. `alloc` takes {name: (shape, dtype)} of every argument once
    the pass has found the word widths, and returns the arrays each is
    written into (``Staging.alloc``: views of one buffer); by default new
    arrays. Returns (args, F)."""
    from ffmpeg_ht_tpu_torch.utils import native
    F = len(frames_cols)
    N = fg.ncblks

    bh, bw = lane_raster_dims(fg)
    lane_span = N * bh * bw                 # one frame's lane-raster size
    pf_i, pf_v = [], []
    for f, fc in enumerate(frames_cols):
        for (ridx, rval) in fc["host_pf"]:
            pf_i.append(ridx + f * lane_span)
            pf_v.append(rval)
    pdt = np.float32 if fg.geom.transform == mk.DWT97 else np.int32
    # pow2 capacity, as the JAX program's; pads index the trash slot one
    # past the frames' lane rasters
    cap = 16
    n_pf = sum(len(i) for i in pf_i)
    while cap < n_pf:
        cap *= 2

    vec = ((F * N,), np.int32)
    args = {}

    def words_out(shapes):
        specs = dict(zip(("msw", "melw", "vlcw"),
                         ((s, np.uint32) for s in shapes)))
        specs.update(pLSB=vec, maxbp=vec, ms_lim=vec, mel_lim=vec, qws=vec,
                     qhs=vec, magb=vec, istep=vec, scale97=vec,
                     fscale=((F * N,), np.float32), pf_idx=((cap,), np.int32),
                     pf_val=((cap,), pdt))
        args.update(alloc(specs) if alloc is not None else
                    {k: np.empty(*sd) for k, sd in specs.items()})
        return args["msw"], args["melw"], args["vlcw"]

    def stack(key, dtype):
        return np.concatenate([fc[key] for fc in frames_cols]).astype(dtype)

    trace.count("direct_prep_lanes", F * N)
    _w, _m, _v, ms_lim, mel_lim = native.ht_prepare_v3(
        [fc["body"] for fc in frames_cols], stack("off", np.int64),
        stack("lcups", np.int64), stack("pcups", np.int64),
        stack("dev", bool), out=words_out)
    args["ms_lim"][:] = ms_lim
    args["mel_lim"][:] = mel_lim
    for key in ("pLSB", "maxbp", "qws", "qhs"):
        np.concatenate([fc[key] for fc in frames_cols], out=args[key],
                       casting="unsafe")
    for key in ("magb", "istep", "scale97", "fscale"):
        args[key].reshape(F, N)[:] = getattr(fg, key)
    pf_idx, pf_val = args["pf_idx"], args["pf_val"]
    pf_idx[:] = F * lane_span
    pf_val[:] = 0
    if pf_i:
        np.concatenate(pf_i, out=pf_idx[:n_pf], casting="unsafe")
        np.concatenate(pf_v, out=pf_val[:n_pf], casting="unsafe")
    return args, F


_ALIGN = 256       # each staged argument's offset in the buffer


def _bits(a: np.ndarray) -> np.ndarray:
    """`a` as the port sends it to torch: uint32 words as int32 bit
    views, other arrays as they are."""
    return a.view(np.int32) if a.dtype == np.uint32 else a


class Staging:
    """One program call's arguments in one byte buffer, each at a
    256-byte aligned offset, written once and sent to `device` in one
    copy.

    ``alloc`` (the `alloc` of ``finish_v3_numpy``) lays the buffer out as
    ``host`` and returns numpy views of it: page-locked memory from
    torch's host cache for a CUDA device, plain memory otherwise.
    ``to_torch(stage.host, device)`` queues the one copy on the current
    stream, from the page-locked tensor, so the host cache records an
    event on it and hands the block out again only once the copy has run:
    the buffer needs no other guard while later calls stage theirs.
    ``views`` then gives each argument as a typed view of the copy."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.host = None
        self.layout = {}        # name -> (start, end, shape, torch dtype)

    def alloc(self, specs):
        """{name: (shape, numpy dtype)} -> {name: numpy view} of one new
        buffer, ``host``."""
        pos, spans = 0, {}
        for k, (shape, dtype) in specs.items():
            pos = -(-pos // _ALIGN) * _ALIGN
            end = pos + int(np.prod(shape)) * np.dtype(dtype).itemsize
            spans[k], pos = (pos, end, tuple(shape)), end
        self.host = torch.empty(pos, dtype=torch.uint8,
                                pin_memory=self.device.type == "cuda")
        buf = self.host.numpy()
        views = {k: buf[a:e].view(specs[k][1]).reshape(s)
                 for k, (a, e, s) in spans.items()}
        self.layout = {k: (a, e, s, torch.from_numpy(_bits(views[k])).dtype)
                       for k, (a, e, s) in spans.items()}
        return views

    def views(self, dev: torch.Tensor, frames: int) -> Dict[str, torch.Tensor]:
        """The staged arguments of `frames` frames as typed views of `dev`,
        the copy of ``host`` on the device (``to_torch``); counts
        ``staged_frames`` and ``staged_bytes``. Drops the host buffer."""
        trace.count("staged_frames", frames)
        trace.count("staged_bytes", dev.numel())
        self.host = None
        return {k: dev[a:e].view(td).reshape(s)
                for k, (a, e, s, td) in self.layout.items()}


@trace.timed("upload")
def to_torch(a, device) -> torch.Tensor:
    """numpy -> torch on `device` (uint32 arrays as int32 bit views,
    ``_bits``), or a host tensor, ``Staging.host``, as it is.

    A CUDA upload comes from page-locked memory (an array is copied into
    it first; a staged buffer is there already) and is queued on the
    current stream, so it does not wait for the stream's earlier work."""
    cuda = torch.device(device).type == "cuda"
    if isinstance(a, torch.Tensor):
        t = a
    else:
        t = torch.from_numpy(_bits(np.ascontiguousarray(a)))
        t = t.pin_memory() if cuda else t
    return t.to(device, non_blocking=cuda)


def finish_v3(fg, frames_cols, total, device):
    """``finish_v3_numpy`` staged and moved to `device` in one copy
    (``Staging``): (args dict of tensors, F)."""
    stage = Staging(device)
    _args, F = finish_v3_numpy(fg, frames_cols, total, stage.alloc)
    return stage.views(to_torch(stage.host, device), F), F
