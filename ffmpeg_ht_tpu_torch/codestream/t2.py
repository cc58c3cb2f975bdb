"""Tier-2: packet-header decoding and code-block bitstream extraction.

Behavior parity: jpeg2000_decode_packet (jpeg2000dec.c:1136-1541), the five
progression orders (jpeg2000dec.c:1544-1833), and the HT placeholder-pass /
HT-MIXED segment-length state machine (jpeg2000dec.c:1256-1439).

Output: Codeblock.data byte payloads + per-codeblock metadata (npasses, zbp,
pass_lengths, modes) attached to the geometry tree — the raw material the
device batcher packs into static-shape arrays.
"""

from __future__ import annotations

from ffmpeg_ht_tpu_torch.codestream import markers as mk
from ffmpeg_ht_tpu_torch.codestream.bitio import ByteReader, PacketBitReader
from ffmpeg_ht_tpu_torch.codestream.geometry import (Tile, ceildiv, ceildivpow2)
from ffmpeg_ht_tpu_torch.codestream.structures import MainHeader, TileHeader
from ffmpeg_ht_tpu_torch.utils.errors import InvalidData, PatchWelcome
from ffmpeg_ht_tpu_torch.utils.log import logger


def _log2(x: int) -> int:
    """av_log2: floor(log2(x)); 0 for x == 0."""
    return x.bit_length() - 1 if x > 0 else 0


def needs_termination(style: int, passno: int) -> int:
    """Parity with jpeg2000.h:302-317."""
    if style & mk.CBLK_BYPASS:
        ptype = passno % 3
        passno //= 3
        if ptype == 0 and passno > 2:
            return 2
        if ptype == 2 and passno > 2:
            return 1
        if style & mk.CBLK_TERMALL:
            return 2 if passno > 2 else 1
    if style & mk.CBLK_TERMALL:
        return 1
    return 0


class _TileStreams:
    """Stream-selection state over a tile's tile-parts.

    Mirrors select_stream/select_header (jpeg2000dec.c:1099-1134): one cursor
    per tile part; the header cursor may instead come from PPM/PPT packed
    headers.
    """

    def __init__(self, hdr: MainHeader, th: TileHeader):
        parts = sorted(th.tile_parts, key=lambda tp: tp.tp_index)
        self.tpg = [ByteReader(tp.data) for tp in parts]
        self.header_tpg = []
        if hdr.has_ppm:
            for tp in parts:
                self.header_tpg.append(ByteReader(tp.ppm_header or b""))
        self.ppt_stream = ByteReader(th.packed_headers) if th.has_ppt else None
        self.tp_index = 0
        self.br = PacketBitReader(ByteReader(b""))
        self.br.bit_index = 8

    def select_header(self, hdr: MainHeader) -> None:
        if self.tp_index < len(self.header_tpg):
            self.br.g = self.header_tpg[self.tp_index]
        else:
            self.br.g = ByteReader(b"")
        if self.br.g.bytes_left() == 0 and self.br.bit_index == 8:
            logger.warning("PPM packet header bytes too short")
            if self.tp_index < len(self.tpg) - 1:
                self.tp_index += 1
                self.br.g = self.tpg[self.tp_index]

    def select_stream(self, csty: int) -> None:
        if self.tp_index < len(self.tpg):
            self.br.g = self.tpg[self.tp_index]
        else:
            self.br.g = ByteReader(b"")
        while (self.br.g.bytes_left() == 0 and self.br.bit_index == 8
               and self.tp_index < len(self.tpg) - 1):
            self.tp_index += 1
            self.br.g = self.tpg[self.tp_index]
        if csty & mk.CSTY_SOP:
            if self.br.g.peek_u32() == mk.SOP_FIXED_BYTES:
                self.br.g.skip(mk.SOP_BYTE_LENGTH)
            else:
                logger.error("SOP marker not found")


_CBLK_LAYER_STATE = ("npasses", "lblock", "modes", "ht_plhd", "length",
                     "nb_terminations", "nb_terminationsinc", "incl",
                     "zbp", "nonzerobits")


def _plt_skip(streams: _TileStreams, n: int) -> None:
    """Skip one packet's bytes using its PLT length (incl. SOP/EPH),
    walking tile-part boundaries like select_stream does."""
    while n > 0:
        g = streams.tpg[streams.tp_index] \
            if streams.tp_index < len(streams.tpg) else None
        if g is None:
            raise InvalidData("PLT skip past stream end")
        take = min(n, g.bytes_left())
        if take == 0:
            if streams.tp_index >= len(streams.tpg) - 1:
                raise InvalidData("PLT skip past stream end")
            streams.tp_index += 1
            continue
        g.skip(take)
        n -= take
    streams.br.bit_index = 8


def decode_packet(hdr: MainHeader, th: TileHeader, tile: Tile,
                  streams: _TileStreams, codsty, rlevel, precno: int,
                  layno: int, expn, numgbits: int,
                  discard: bool = False, plt_state=None) -> None:
    """One packet (jpeg2000dec.c:1136-1541).

    `discard` parses the packet and advances the stream but leaves every
    codeblock's decoded state untouched (the max_layers quality cap: a
    capped layer's packets still occupy stream bytes, and in
    layer-interleaved progressions they sit between packets we keep).
    With PLT lengths available (`plt_state`) a discarded packet is
    skipped bytewise instead of bit-parsed — the random-access use of
    the PLT table (T.800 A.7.3)."""
    prec0 = rlevel.band[0].prec[precno]
    if layno < prec0.decoded_layers:
        return
    prec0.decoded_layers = layno + 1

    plt_len = None
    if plt_state is not None:
        i = plt_state["idx"]
        plt_state["idx"] = i + 1
        if i < len(plt_state["lengths"]):
            plt_len = plt_state["lengths"][i]
    if discard and plt_len is not None \
            and not hdr.has_ppm and not th.has_ppt:
        streams.select_stream(0)        # position at the packet start
        _plt_skip(streams, plt_len)
        return

    saves = None
    if discard:
        saves = []
        for band in rlevel.band:
            if (band.coord[0][0] == band.coord[0][1]
                    or band.coord[1][0] == band.coord[1][1]):
                continue
            for cblk in band.prec[precno].cblk:
                saves.append((cblk,
                              {k: getattr(cblk, k, 0)
                               for k in _CBLK_LAYER_STATE},
                              list(cblk.pass_lengths),
                              list(cblk.data_start), len(cblk.data)))

    br = streams.br
    if hdr.has_ppm:
        streams.select_header(hdr)
    elif th.has_ppt:
        br.g = streams.ppt_stream
    else:
        streams.select_stream(codsty.csty)

    if not br.bit():
        # empty packet
        br.flush()
        _skip_eph(br, codsty)
        _post_header(hdr, th, streams, codsty)
        return

    for band in rlevel.band:
        if (band.coord[0][0] == band.coord[0][1]
                or band.coord[1][0] == band.coord[1][1]):
            continue
        prec = band.prec[precno]
        for cblkno in range(prec.nb_codeblocks_width * prec.nb_codeblocks_height):
            cblk = prec.cblk[cblkno]
            if not cblk.incl:
                incl = False
                cblk.modes = codsty.cblk_style
                if cblk.modes >= mk.CTSY_HTJ2K_F:
                    cblk.ht_plhd = True
                if layno > 0:
                    incl = prec.cblkincl.decode(br, cblkno, 1) == 0
                incl = prec.cblkincl.decode(br, cblkno, layno + 1) == layno
                if incl:
                    zbp = prec.zerobits.decode(br, cblkno, 100)
                    # bug-compat: reference uses component 0's roi_shift here
                    # (tile->comp->roi_shift, jpeg2000dec.c:1186)
                    v = expn[_bandno(band, rlevel)] + numgbits - 1 \
                        - (zbp - tile.comp[0].roi_shift)
                    if v < 0 or v > 30:
                        raise InvalidData(f"nonzerobits {v} invalid")
                    cblk.incl = True
                    cblk.nonzerobits = v
                    cblk.zbp = zbp
                    cblk.lblock = 3
            else:
                incl = bool(br.bit())

            if not incl:
                cblk.lengthinc = []
                continue

            newpasses = _getnpasses(br)
            if cblk.npasses + newpasses >= mk.MAX_PASSES:
                raise PatchWelcome("Too many passes")
            llen = _getlblockinc(br)
            if cblk.lblock + llen + _log2(newpasses) > 16:
                raise PatchWelcome("Block length beyond 16 bits")
            cblk.lblock += llen
            cblk.lengthinc = []
            cblk.nb_terminationsinc = 0

            # count necessary terminations for non-HT blocks
            if not (cblk.modes & mk.CTSY_HTJ2K_F):
                newpasses_copy = newpasses
                npasses_copy = cblk.npasses
                while newpasses_copy:
                    np1 = 0
                    while np1 < newpasses_copy:
                        np1 += 1
                        if needs_termination(codsty.cblk_style,
                                             npasses_copy + np1 - 1):
                            cblk.nb_terminationsinc += 1
                            break
                    npasses_copy += np1
                    newpasses_copy -= np1

            _decode_lengths(br, cblk, codsty, newpasses)

    br.flush()
    _skip_eph(br, codsty)
    _post_header(hdr, th, streams, codsty)

    # read code-block payload bytes from the body stream
    for band in rlevel.band:
        if (band.coord[0][0] == band.coord[0][1]
                or band.coord[1][0] == band.coord[1][1]):
            continue
        prec = band.prec[precno]
        for cblkno in range(prec.nb_codeblocks_width * prec.nb_codeblocks_height):
            cblk = prec.cblk[cblkno]
            lengthinc = getattr(cblk, "lengthinc", None)
            if not lengthinc and not cblk.nb_terminationsinc:
                continue
            for inc in lengthinc:
                if br.g.bytes_left() < inc:
                    raise InvalidData("Block length too large")
                cblk.data += br.g.read(inc)
                cblk.length += inc
                if cblk.nb_terminationsinc:
                    cblk.nb_terminationsinc -= 1
                    cblk.nb_terminations += 1
                    cblk.data += b"\xFF\xFF"
                    cblk.length += 2
                    cblk.data_start.append(cblk.length)
            cblk.lengthinc = []

    if saves is not None:
        # max_layers discard: stream consumed, codeblock state restored
        for cblk, st, plens, dstarts, dlen in saves:
            for k, v in st.items():
                setattr(cblk, k, v)
            cblk.pass_lengths[:] = plens
            cblk.data_start[:] = dstarts
            del cblk.data[dlen:]
            cblk.lengthinc = []


def _bandno(band, rlevel) -> int:
    return rlevel.band.index(band)


def _skip_eph(br: PacketBitReader, codsty) -> None:
    if codsty.csty & mk.CSTY_EPH:
        if br.g.peek_u16() == mk.EPH:
            br.g.skip(2)
        else:
            logger.error("EPH marker not found")


def _post_header(hdr: MainHeader, th: TileHeader, streams: _TileStreams,
                 codsty) -> None:
    """After the header: switch to the body stream when PPM/PPT in use."""
    if hdr.has_ppm or th.has_ppt:
        streams.select_stream(codsty.csty)


def _getnpasses(br: PacketBitReader) -> int:
    """jpeg2000dec.c:1073-1086."""
    if not br.bit():
        return 1
    if not br.bit():
        return 2
    num = br.bits(2)
    if num != 3:
        return 3 + num
    num = br.bits(5)
    if num != 31:
        return 6 + num
    return 37 + br.bits(7)


def _getlblockinc(br: PacketBitReader) -> int:
    res = 0
    while br.bit():
        res += 1
    return res


def _decode_lengths(br: PacketBitReader, cblk, codsty, newpasses: int) -> None:
    """Segment-length decode incl. the HT placeholder state machine
    (jpeg2000dec.c:1256-1439)."""
    bypass_term_threshold = 0
    bits_to_read = 0
    segment_bytes = 0
    segment_passes = 0
    next_segment_passes = 0

    if cblk.ht_plhd:
        href_passes = (cblk.npasses + newpasses - 1) % 3
        segment_passes = newpasses - href_passes
        pass_bound = 2
        bits_to_read = cblk.lblock
        if segment_passes < 1:
            # No HT Cleanup pass here; placeholder passes or an original
            # J2K block bitstream (MIXED mode).
            segment_passes = newpasses
            while pass_bound <= segment_passes:
                bits_to_read += 1
                pass_bound += pass_bound
            segment_bytes = br.bits(bits_to_read)
            if segment_bytes:
                if cblk.modes & mk.HT_MIXED:
                    cblk.ht_plhd = False
                    cblk.modes &= ~mk.CTSY_HTJ2K_F & 0xFF
                else:
                    logger.warning("HT length information invalid")
        else:
            while pass_bound <= segment_passes:
                bits_to_read += 1
                pass_bound += pass_bound
            segment_bytes = br.bits(bits_to_read)
            if segment_bytes:
                if not (cblk.modes & mk.HT_MIXED):
                    # first HT Cleanup pass
                    if segment_bytes < 2:
                        logger.warning("HT length information invalid")
                    next_segment_passes = 2
                    cblk.ht_plhd = False
                    cblk.pass_lengths[0] = segment_bytes
                elif (cblk.lblock > 3 and segment_bytes > 1
                        and (segment_bytes >> (bits_to_read - 1)) == 0):
                    # first HT Cleanup pass (length MSB is 0)
                    next_segment_passes = 2
                    cblk.ht_plhd = False
                    cblk.pass_lengths[0] = segment_bytes
                else:
                    # an original (non-HT) block coding pass
                    cblk.modes &= ~mk.CTSY_HTJ2K_F & 0xFF
                    cblk.ht_plhd = False
                    segment_passes = newpasses
                    while pass_bound <= segment_passes:
                        bits_to_read += 1
                        pass_bound += pass_bound
                        segment_bytes = (segment_bytes << 1) | br.bit()
            else:
                # probably placeholder passes; read extra length bits
                segment_passes = newpasses
                if pass_bound <= segment_passes:
                    while True:
                        bits_to_read += 1
                        pass_bound += pass_bound
                        segment_bytes = (segment_bytes << 1) | br.bit()
                        if pass_bound > segment_passes:
                            break
                    if segment_bytes:
                        if cblk.modes & mk.HT_MIXED:
                            cblk.modes &= ~mk.CTSY_HTJ2K_F & 0xFF
                            cblk.ht_plhd = False
                        else:
                            logger.warning("HT length information invalid")
    elif cblk.modes & mk.CTSY_HTJ2K_F:
        # quality layer commences with a non-initial HT coding pass
        segment_passes = cblk.npasses % 3
        if segment_passes == 0:
            # HT Cleanup pass; next segment has refinement passes
            segment_passes = 1
            next_segment_passes = 2
            if segment_bytes == 1:
                logger.warning("HT length information invalid")
        else:
            # 1 -> HT SigProp next; 2 -> HT MagRef next
            segment_passes = 3 - segment_passes if newpasses > 1 else 1
            next_segment_passes = 1
            bits_to_read = _log2(segment_passes)
        bits_to_read += cblk.lblock
        segment_bytes = br.bits(bits_to_read)
        cblk.pass_lengths[1] += segment_bytes
    elif not (cblk.modes & (mk.CBLK_TERMALL | mk.CBLK_BYPASS)):
        # common non-HT case: single segment
        bits_to_read = cblk.lblock + _log2(newpasses)
        segment_bytes = br.bits(bits_to_read)
        segment_passes = newpasses
    elif cblk.modes & mk.CBLK_TERMALL:
        # RESTART mode
        bits_to_read = cblk.lblock
        segment_bytes = br.bits(bits_to_read)
        segment_passes = 1
        next_segment_passes = 1
    else:
        # BYPASS mode
        bypass_term_threshold = 10
        if cblk.npasses < bypass_term_threshold:
            segment_passes = min(bypass_term_threshold - cblk.npasses, newpasses)
            while (2 << bits_to_read) <= segment_passes:
                bits_to_read += 1
            next_segment_passes = 2
        elif (cblk.npasses - bypass_term_threshold) % 3 < 2:
            segment_passes = (2 - (cblk.npasses - bypass_term_threshold) % 3
                              if newpasses > 1 else 1)
            bits_to_read = _log2(segment_passes)
            next_segment_passes = 1
        else:
            segment_passes = 1
            next_segment_passes = 2
        bits_to_read += cblk.lblock
        segment_bytes = br.bits(bits_to_read)

    cblk.npasses += segment_passes
    cblk.lengthinc.append(segment_bytes)

    if (cblk.modes & mk.CTSY_HTJ2K_F) and not cblk.ht_plhd:
        newpasses -= segment_passes
        while newpasses > 0:
            segment_passes = next_segment_passes if newpasses > 1 else 1
            next_segment_passes = 3 - next_segment_passes
            bits_to_read = cblk.lblock + _log2(segment_passes)
            segment_bytes = br.bits(bits_to_read)
            newpasses -= segment_passes
            # FAST refinement pass
            cblk.pass_lengths[1] += segment_bytes
            cblk.npasses += segment_passes
            cblk.lengthinc.append(segment_bytes)
    else:
        newpasses -= segment_passes
        while newpasses > 0:
            if bypass_term_threshold != 0:
                segment_passes = next_segment_passes if newpasses > 1 else 1
                next_segment_passes = 3 - next_segment_passes
                bits_to_read = cblk.lblock + _log2(segment_passes)
            else:
                if not (cblk.modes & mk.CBLK_TERMALL):
                    logger.warning("Corrupted packet header")
                segment_passes = 1
                bits_to_read = cblk.lblock
            segment_bytes = br.bits(bits_to_read)
            newpasses -= segment_passes
            cblk.npasses += segment_passes
            cblk.lengthinc.append(segment_bytes)


def decode_tile_packets(hdr: MainHeader, tileno: int, tile: Tile,
                        max_layers: int = 0) -> None:
    """All packets of a tile (jpeg2000_decode_packets, jpeg2000dec.c:1835-1869).

    `max_layers` > 0 keeps only the first N quality layers (the
    progressive-quality analog of the resolution cap `reduction_factor`;
    capped layers' packets are parsed and skipped in place)."""
    th = hdr.tiles[tileno]
    distribute_ppm_headers(hdr)
    streams = _TileStreams(hdr, th)
    streams.br.bit_index = 8
    plt_state = {"lengths": th.plt_lengths, "idx": 0} \
        if th.plt_lengths else None

    if th.poc.entries:
        for e in th.poc.entries:
            _po_iteration(hdr, th, tile, streams, e.rspoc, e.cspoc,
                          min(e.lyepoc, th.codsty[0].nlayers), e.repoc,
                          min(e.cepoc, hdr.siz.ncomponents), e.ppoc,
                          max_layers=max_layers, plt_state=plt_state)
    else:
        _po_iteration(hdr, th, tile, streams, 0, 0, th.codsty[0].nlayers,
                      33, hdr.siz.ncomponents, th.codsty[0].prog_order,
                      max_layers=max_layers, plt_state=plt_state)


def distribute_ppm_headers(hdr: MainHeader) -> None:
    """Slice hdr.packed_headers by the Nppm prefixes in SOD order on
    first use (T.800 A.7.4; ref jpeg2000dec.c PPM handling)."""
    if hdr.has_ppm and hdr.tile_part_order \
            and hdr.tile_part_order[0].ppm_header is None:
        g = ByteReader(hdr.packed_headers)
        for tp in hdr.tile_part_order:
            size = g.u32()
            if g.bytes_left() < size:
                raise InvalidData("PPM too short")
            tp.ppm_header = g.read(size)


def _expn_slice(qntsty, reslevelno: int):
    off = 3 * (reslevelno - 1) + 1 if reslevelno else 0
    return qntsty.expn[off:]


def packet_order(hdr: MainHeader, th: TileHeader, tile: Tile,
                 nlayers: int = 1):
    """(compno, reslevelno, precno, layno) tuples in stream order.

    Helper for the native T2 fast path: replays the same progression
    iteration decode_tile_packets uses — including POC entries and the
    per-precinct decoded-layers dedup (decode_packet:106-108, ref
    jpeg2000dec.c:1147-1150) — without touching any stream. The emitted
    sequence is therefore exactly the packet sequence in the stream."""
    order = []
    decoded = {}

    def visit(compno, reslevelno, precno, layno):
        key = (compno, reslevelno, precno)
        if layno < decoded.get(key, 0):
            return
        decoded[key] = layno + 1
        order.append((compno, reslevelno, precno, layno))

    if th.poc.entries:
        for e in th.poc.entries:
            _po_iteration(hdr, th, tile, None, e.rspoc, e.cspoc,
                          min(e.lyepoc, nlayers), e.repoc,
                          min(e.cepoc, hdr.siz.ncomponents), e.ppoc,
                          visit=visit)
    else:
        _po_iteration(hdr, th, tile, None, 0, 0, nlayers, 33,
                      hdr.siz.ncomponents, th.codsty[0].prog_order,
                      visit=visit)
    return order


def _po_iteration(hdr: MainHeader, th: TileHeader, tile: Tile,
                  streams: _TileStreams, rspoc: int, cspoc: int, lyepoc: int,
                  repoc: int, cepoc: int, ppoc: int, visit=None,
                  max_layers: int = 0, plt_state=None) -> None:
    """One progression-order iteration (jpeg2000dec.c:1544-1833)."""
    siz = hdr.siz
    ncomp = siz.ncomponents

    def dec(codsty, rlevel, precno, layno, qntsty, reslevelno):
        if visit is not None:
            compno = next(i for i, c in enumerate(th.codsty)
                          if c is codsty)
            visit(compno, reslevelno, precno, layno)
            return
        decode_packet(hdr, th, tile, streams, codsty, rlevel, precno, layno,
                      _expn_slice(qntsty, reslevelno), qntsty.nguardbits,
                      discard=bool(max_layers) and layno >= max_layers,
                      plt_state=plt_state)

    if ppoc == mk.PGOD_RLCP or ppoc == mk.PGOD_LRCP:
        outer_r = ppoc == mk.PGOD_RLCP

        def iter_rl():
            ok = [True]
            if outer_r:
                for r in range(rspoc, repoc):
                    if not ok[0]:
                        break
                    ok[0] = False
                    for l in range(lyepoc):
                        yield r, l, ok
            else:
                for l in range(lyepoc):
                    ok[0] = True
                    for r in range(rspoc, repoc):
                        if not ok[0]:
                            break
                        ok[0] = False
                        yield r, l, ok

        for r, l, ok in iter_rl():
            for compno in range(cspoc, cepoc):
                codsty = th.codsty[compno]
                qntsty = th.qntsty[compno]
                if r < codsty.nreslevels:
                    rlevel = tile.comp[compno].reslevel[r]
                    ok[0] = True
                    for precno in range(rlevel.num_precincts_x
                                        * rlevel.num_precincts_y):
                        dec(codsty, rlevel, precno, l, qntsty, r)

    elif ppoc == mk.PGOD_CPRL:
        for compno in range(cspoc, cepoc):
            comp = tile.comp[compno]
            codsty = th.codsty[compno]
            qntsty = th.qntsty[compno]
            if rspoc >= min(codsty.nreslevels, repoc):
                continue
            step_x, step_y = 32, 32
            for r in range(rspoc, min(codsty.nreslevels, repoc)):
                rr = codsty.nreslevels - 1 - r
                rl = comp.reslevel[r]
                step_x = min(step_x, rl.log2_prec_width + rr)
                step_y = min(step_y, rl.log2_prec_height + rr)
            if step_x >= 31 or step_y >= 31:
                raise PatchWelcome("CPRL with large step")
            step_x, step_y = 1 << step_x, 1 << step_y
            cdx, cdy = siz.components[compno].dx, siz.components[compno].dy

            y = tile.coord[1][0]
            while y < tile.coord[1][1]:
                x = tile.coord[0][0]
                while x < tile.coord[0][1]:
                    for r in range(rspoc, min(codsty.nreslevels, repoc)):
                        rr = codsty.nreslevels - 1 - r
                        rl = comp.reslevel[r]
                        xc, yc = x // cdx, y // cdy
                        if (yc % (1 << (rl.log2_prec_height + rr))
                                and y != tile.coord[1][0]):
                            continue
                        if (xc % (1 << (rl.log2_prec_width + rr))
                                and x != tile.coord[0][0]):
                            continue
                        prcx = ceildivpow2(xc, rr) >> rl.log2_prec_width
                        prcy = ceildivpow2(yc, rr) >> rl.log2_prec_height
                        prcx -= ceildivpow2(comp.coord_o[0][0], rr) >> rl.log2_prec_width
                        prcy -= ceildivpow2(comp.coord_o[1][0], rr) >> rl.log2_prec_height
                        precno = prcx + rl.num_precincts_x * prcy
                        if prcx >= rl.num_precincts_x or prcy >= rl.num_precincts_y \
                                or prcx < 0 or prcy < 0:
                            logger.warning("prc %d %d outside limits", prcx, prcy)
                            continue
                        for layno in range(lyepoc):
                            dec(codsty, rl, precno, layno, qntsty, r)
                    x = (x // step_x + 1) * step_x
                y = (y // step_y + 1) * step_y

    elif ppoc in (mk.PGOD_RPCL, mk.PGOD_PCRL):
        if ppoc == mk.PGOD_RPCL:
            r_range = range(rspoc, repoc)
        else:
            r_range = [None]  # position loop is outermost for PCRL

        def precinct_visit(r_outer):
            step_x, step_y = (30, 30) if ppoc == mk.PGOD_RPCL else (32, 32)
            for compno in range(cspoc, cepoc):
                comp = tile.comp[compno]
                codsty = th.codsty[compno]
                rs = [r_outer] if r_outer is not None else \
                    range(rspoc, min(codsty.nreslevels, repoc))
                for r in rs:
                    if r is None or r >= codsty.nreslevels:
                        continue
                    rr = codsty.nreslevels - 1 - r
                    rl = comp.reslevel[r]
                    step_x = min(step_x, rl.log2_prec_width + rr)
                    step_y = min(step_y, rl.log2_prec_height + rr)
            if step_x >= 31 or step_y >= 31:
                raise PatchWelcome("progression with large step")
            sx, sy = 1 << step_x, 1 << step_y

            y = tile.coord[1][0]
            while y < tile.coord[1][1]:
                x = tile.coord[0][0]
                while x < tile.coord[0][1]:
                    for compno in range(cspoc, cepoc):
                        comp = tile.comp[compno]
                        codsty = th.codsty[compno]
                        qntsty = th.qntsty[compno]
                        cdx = siz.components[compno].dx
                        cdy = siz.components[compno].dy
                        if not cdx or not cdy:
                            raise InvalidData("zero subsampling")
                        rs = [r_outer] if r_outer is not None else \
                            range(rspoc, min(codsty.nreslevels, repoc))
                        for r in rs:
                            if r >= codsty.nreslevels:
                                continue
                            rr = codsty.nreslevels - 1 - r
                            rl = comp.reslevel[r]
                            trx0 = ceildiv(tile.coord[0][0], cdx << rr)
                            try0 = ceildiv(tile.coord[1][0], cdy << rr)
                            if not (y % (cdy << (rl.log2_prec_height + rr)) == 0
                                    or (y == tile.coord[1][0]
                                        and (try0 << rr)
                                        % (1 << (rr + rl.log2_prec_height)))):
                                continue
                            if not (x % (cdx << (rl.log2_prec_width + rr)) == 0
                                    or (x == tile.coord[0][0]
                                        and (trx0 << rr)
                                        % (1 << (rr + rl.log2_prec_width)))):
                                continue
                            prcx = ceildiv(x, cdx << rr) >> rl.log2_prec_width
                            prcy = ceildiv(y, cdy << rr) >> rl.log2_prec_height
                            prcx -= ceildivpow2(comp.coord_o[0][0], rr) >> rl.log2_prec_width
                            prcy -= ceildivpow2(comp.coord_o[1][0], rr) >> rl.log2_prec_height
                            precno = prcx + rl.num_precincts_x * prcy
                            if prcx >= rl.num_precincts_x or prcy >= rl.num_precincts_y \
                                    or prcx < 0 or prcy < 0:
                                logger.warning("prc %d %d outside limits", prcx, prcy)
                                continue
                            for layno in range(lyepoc):
                                dec(codsty, rl, precno, layno, qntsty, r)
                    x = (x // sx + 1) * sx
                y = (y // sy + 1) * sy

        for r_outer in r_range:
            precinct_visit(r_outer)
