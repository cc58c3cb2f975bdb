"""Tier-2 encoder: tag-tree coding and packet emission.

Behavior parity: tag_tree_code/tag_tree_update, putnumpasses, encode_packet
and encode_packets (ffmpeg's libavcodec/j2kenc.c:249-292, 771-937,
940-1166). Packet geometry comes from codestream/geometry.py so the encoder
and decoder share one grid definition.
"""

from __future__ import annotations

from htbench.frozen.codestream import markers as mk
from htbench.frozen.codestream.geometry import Tile, ceildivpow2


class BitPacker:
    """MSB-first bit packer with 0xFF stuffing (put_bits, j2kenc.c:223-247)."""

    def __init__(self):
        self.buf = bytearray()
        self.bit_index = 8  # forces a fresh byte on first put

    def put_bits(self, val: int, n: int) -> None:
        for _ in range(n):
            if self.bit_index == 8:
                self.bit_index = 1 if (self.buf and self.buf[-1] == 0xFF) else 0
                self.buf.append(0)
            self.buf[-1] |= val << (7 - self.bit_index)
            self.bit_index += 1

    def put_num(self, num: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.put_bits((num >> i) & 1, 1)

    def flush(self) -> None:
        # a packet header may not end on an 0xFF byte: the decoder's
        # flush unconditionally skips one extra byte after 0xFF
        # (jpeg2000_flush, jpeg2000dec.c:85-90), so append the stuffing
        # byte it will consume. Content-dependent and rare — a header
        # whose final byte fills up as all-ones.
        if self.buf and self.buf[-1] == 0xFF:
            self.buf.append(0)
        self.bit_index = 8


class TagTreeEnc:
    """Encoder-side tag tree (j2kenc.c:251-292; layout as jpeg2000.c:41-73)."""

    def __init__(self, w: int, h: int):
        self.w, self.h = w, h
        self.val = []
        self.temp_val = []
        self.vis = []
        self.parent = []
        sizes = []
        while w > 1 or h > 1:
            sizes.append((w, h))
            w, h = -(-w // 2), -(-h // 2)
        sizes.append((w, h))
        base = 0
        self.level_base = []
        for (lw, lh) in sizes:
            self.level_base.append(base)
            base += lw * lh
        self.n = base
        self.val = [0] * base
        self.temp_val = [0] * base
        self.vis = [0] * base
        self.parent = [None] * base
        for lev, (lw, lh) in enumerate(sizes[:-1]):
            pw = sizes[lev + 1][0]
            for y in range(lh):
                for x in range(lw):
                    i = self.level_base[lev] + y * lw + x
                    self.parent[i] = (self.level_base[lev + 1]
                                      + (y // 2) * pw + (x // 2))

    def reset(self, val: int) -> None:
        for i in range(self.n):
            self.val[i] = val
            self.temp_val[i] = 0
            self.vis[i] = 0

    def set_leaf(self, pos: int, val: int) -> None:
        """Set leaf value and propagate minima up (tag_tree_update)."""
        self.val[pos] = val
        node = pos
        while self.parent[node] is not None:
            p = self.parent[node]
            if self.val[p] <= self.val[node]:
                break
            self.val[p] = self.val[node]
            node = p

    def code(self, bp: BitPacker, leaf: int, threshold: int) -> None:
        """tag_tree_code (j2kenc.c:251-285)."""
        stack = []
        node = leaf
        while self.parent[node] is not None:
            stack.append(node)
            node = self.parent[node]
        curval = 0
        while True:
            if curval > self.temp_val[node]:
                self.temp_val[node] = curval
            else:
                curval = self.temp_val[node]
            if self.val[node] >= threshold:
                bp.put_bits(0, threshold - curval)
                curval = threshold
            else:
                bp.put_bits(0, self.val[node] - curval)
                curval = self.val[node]
                if not self.vis[node]:
                    bp.put_bits(1, 1)
                    self.vis[node] = 1
            self.temp_val[node] = curval
            if not stack:
                break
            node = stack.pop()


def putnumpasses(bp: BitPacker, n: int) -> None:
    """j2kenc.c:771-783."""
    if n == 1:
        bp.put_num(0, 1)
    elif n == 2:
        bp.put_num(2, 2)
    elif n <= 5:
        bp.put_num(0xC | (n - 3), 4)
    elif n <= 36:
        bp.put_num(0x1E0 | (n - 6), 9)
    else:
        bp.put_num(0xFF80 | (n - 37), 16)


def encode_packet(out: bytearray, rlevel, layno: int, precno: int,
                  expn, numgbits: int, packetno: int, nlayers: int,
                  sop: bool, eph: bool, header_out=None,
                  roi: int = 0) -> None:
    """Emit one packet (encode_packet, j2kenc.c:786-937).

    With `header_out` set, the packet header bits (and EPH) go there
    instead of `out` — the packed-headers form (PPT marker, T.800 A.7.5;
    decode side t2.py select_stream / jpeg2000dec.c:980-1004). SOP stays
    in the body stream either way (the decoder skips it there via
    _post_header -> select_stream when headers are packed)."""
    hdst = out if header_out is None else header_out
    bp = BitPacker()
    if sop:
        out.extend(bytes([0xFF, 0x91, 0x00, 0x04])
                   + packetno.to_bytes(2, "big"))

    if layno == 0:
        for bandno, band in enumerate(rlevel.band):
            if (band.coord[0][0] >= band.coord[0][1]
                    or band.coord[1][0] >= band.coord[1][1]):
                continue
            prec = band.prec[precno]
            prec.enc_zerobits = TagTreeEnc(max(prec.nb_codeblocks_width, 1),
                                           max(prec.nb_codeblocks_height, 1))
            prec.enc_cblkincl = TagTreeEnc(max(prec.nb_codeblocks_width, 1),
                                           max(prec.nb_codeblocks_height, 1))
            prec.enc_zerobits.reset(99)
            prec.enc_cblkincl.reset(99)
            for pos, cblk in enumerate(prec.cblk):
                e = cblk.enc
                e.incl = False
                e.lblock = 3
                # maxshift ROI (RGN SPrgn = roi): the zerobits tag grows
                # by SPrgn so the decoder's v = magb - (zbp - roi_shift)
                # (t2.py:190-193 / jpeg2000dec.c:1186) recovers the same
                # nonzerobits while placing the coded planes roi lower;
                # its final writeback upshifts background samples back
                # (jpeg2000dec.c:2083-2084, jpeg2000htdec.c:1317-1331)
                prec.enc_zerobits.set_leaf(
                    pos, expn[bandno] + numgbits - 1 - e.nonzerobits + roi)
                incl_layer = nlayers
                for i in range(nlayers):
                    if e.layers[i]["npasses"] > 0:
                        incl_layer = i
                        break
                prec.enc_cblkincl.set_leaf(pos, incl_layer)

    # is the packet empty?
    empty = True
    for band in rlevel.band:
        if (band.coord[0][0] >= band.coord[0][1]
                or band.coord[1][0] >= band.coord[1][1]):
            continue
        for cblk in band.prec[precno].cblk:
            if cblk.enc.layers[layno]["npasses"]:
                empty = False
                break
        if not empty:
            break

    bp.put_bits(0 if empty else 1, 1)
    if empty:
        bp.flush()
        hdst.extend(bp.buf)
        if eph:
            hdst.extend(bytes([0xFF, 0x92]))
        return

    for bandno, band in enumerate(rlevel.band):
        if (band.coord[0][0] >= band.coord[0][1]
                or band.coord[1][0] >= band.coord[1][1]):
            continue
        prec = band.prec[precno]
        for pos, cblk in enumerate(prec.cblk):
            e = cblk.enc
            layer = e.layers[layno]
            # inclusion information
            if not e.incl:
                prec.enc_cblkincl.code(bp, pos, layno + 1)
            else:
                bp.put_bits(1 if layer["npasses"] > 0 else 0, 1)
            if not layer["npasses"]:
                continue
            # zero-bitplanes information
            if not e.incl:
                prec.enc_zerobits.code(bp, pos, 100)
                e.incl = True
            putnumpasses(bp, layer["npasses"])

            segments = getattr(e, "ht_segments", None)
            if segments and len(segments) > 1:
                # HT multi-segment lengths (Cleanup, then SigProp+MagRef):
                # the decoder reads lblock + av_log2(seg_passes) bits per
                # segment (t2._decode_lengths HT branch)
                llen = 0
                for p_, b_ in segments:
                    blen = b_.bit_length() if b_ else 1
                    plog = p_.bit_length() - 1
                    llen = max(llen, blen - plog - e.lblock)
                llen = max(llen, 0)
                e.lblock += llen
                bp.put_bits(1, llen)
                bp.put_bits(0, 1)
                for p_, b_ in segments:
                    bp.put_num(b_, e.lblock + (p_.bit_length() - 1))
            else:
                length = layer["data_len"]
                if layno == nlayers - 1 and layer["cum_passes"]:
                    length += len(e.passes[layer["cum_passes"] - 1].flushed)
                llen = 0
                np_log = (layer["npasses"]).bit_length() - 1  # av_log2
                len_log = length.bit_length() - 1 if length else 0
                if e.lblock + np_log < len_log + 1:
                    llen = len_log + 1 - e.lblock - np_log
                if getattr(e, "mixed_ht", False):
                    # MIXED-set HT Cleanup classification (decode side
                    # t2.py:321 / jpeg2000dec.c:1287-1299) requires
                    # lblock > 3 AND a leading zero on the length field;
                    # widen so lblock >= max(4, av_log2(len) + 2)
                    llen = max(llen, 4 - e.lblock - np_log,
                               len_log + 2 - e.lblock - np_log)
                e.lblock += llen
                bp.put_bits(1, llen)
                bp.put_bits(0, 1)
                bp.put_num(length, e.lblock + np_log)

    bp.flush()
    hdst.extend(bp.buf)
    if eph:
        hdst.extend(bytes([0xFF, 0x92]))

    for band in rlevel.band:
        if (band.coord[0][0] >= band.coord[0][1]
                or band.coord[1][0] >= band.coord[1][1]):
            continue
        for cblk in band.prec[precno].cblk:
            e = cblk.enc
            layer = e.layers[layno]
            if layer["npasses"]:
                out.extend(e.data[layer["data_start"]:
                                  layer["data_start"] + layer["data_len"]])
                if layno == nlayers - 1 and layer["cum_passes"]:
                    out.extend(e.passes[layer["cum_passes"] - 1].flushed)


def encode_packets(out: bytearray, tile: Tile, nlayers: int, prog: int,
                   sop: bool, eph: bool, chroma_shift=(0, 0),
                   boundaries=None, header_out=None, roi: int = 0) -> None:
    """All packets of one tile in progression order (j2kenc.c:940-1166).

    `boundaries`, when given, collects the byte offset after every packet
    — the legal tile-part split points (a packet may not straddle
    tile-parts, T.800 A.4.2). `header_out` collects packet headers for
    the PPT packed-headers form (see encode_packet)."""
    codsty = tile.codsty[0]
    qntsty_of = lambda compno: tile.qntsty[compno]
    ncomponents = len(tile.comp)
    packetno = 0

    def expn_slice(compno, reslevelno):
        q = qntsty_of(compno)
        off = 3 * reslevelno - 2 if reslevelno else 0
        return q.expn[off:], q.nguardbits

    def emit(compno, reslevelno, precno, layno):
        nonlocal packetno
        rlevel = tile.comp[compno].reslevel[reslevelno]
        expn, ngb = expn_slice(compno, reslevelno)
        encode_packet(out, rlevel, layno, precno, expn, ngb, packetno,
                      nlayers, sop, eph, header_out, roi)
        packetno += 1
        if boundaries is not None:
            boundaries.append(len(out))

    if prog == mk.PGOD_LRCP:
        for layno in range(nlayers):
            for reslevelno in range(codsty.nreslevels):
                for compno in range(ncomponents):
                    rl = tile.comp[compno].reslevel[reslevelno]
                    for precno in range(rl.num_precincts_x * rl.num_precincts_y):
                        emit(compno, reslevelno, precno, layno)
    elif prog == mk.PGOD_RLCP:
        for reslevelno in range(codsty.nreslevels):
            for layno in range(nlayers):
                for compno in range(ncomponents):
                    rl = tile.comp[compno].reslevel[reslevelno]
                    for precno in range(rl.num_precincts_x * rl.num_precincts_y):
                        emit(compno, reslevelno, precno, layno)
    else:
        # positional orders RPCL/PCRL/CPRL (j2kenc.c:1005-1161)
        tc = tile.coord

        def precinct_at(compno, reslevelno, x, y):
            comp = tile.comp[compno]
            rl = comp.reslevel[reslevelno]
            reduced = codsty.nreslevels - 1 - reslevelno
            sub = (chroma_shift[0] if (compno + 1) & 2 else 0,
                   chroma_shift[1] if (compno + 1) & 2 else 0)
            trx0 = ceildivpow2(tc[0][0], sub[0] + reduced)
            try0 = ceildivpow2(tc[1][0], sub[1] + reduced)
            if not (y % (1 << (rl.log2_prec_height + reduced + sub[1])) == 0
                    or (y == tc[1][0] and (try0 << reduced)
                        % (1 << (reduced + rl.log2_prec_height)))):
                return None
            if not (x % (1 << (rl.log2_prec_width + reduced + sub[0])) == 0
                    or (x == tc[0][0] and (trx0 << reduced)
                        % (1 << (reduced + rl.log2_prec_width)))):
                return None
            prcx = ceildivpow2(x, sub[0] + reduced) >> rl.log2_prec_width
            prcy = ceildivpow2(y, sub[1] + reduced) >> rl.log2_prec_height
            prcx -= ceildivpow2(comp.coord_o[0][0], reduced) >> rl.log2_prec_width
            prcy -= ceildivpow2(comp.coord_o[1][0], reduced) >> rl.log2_prec_height
            if prcx >= rl.num_precincts_x or prcy >= rl.num_precincts_y \
                    or prcx < 0 or prcy < 0:
                return None
            return prcx + rl.num_precincts_x * prcy

        def step_of(compno_range, reslevel_range):
            sx = sy = 32
            for compno in compno_range:
                comp = tile.comp[compno]
                for reslevelno in reslevel_range:
                    reduced = codsty.nreslevels - 1 - reslevelno
                    rl = comp.reslevel[reslevelno]
                    sx = min(sx, rl.log2_prec_width + reduced)
                    sy = min(sy, rl.log2_prec_height + reduced)
            return 1 << sx, 1 << sy

        def ypos_iter(step_y):
            y = tc[1][0]
            while y < tc[1][1]:
                yield y
                y = (y // step_y + 1) * step_y

        def xpos_iter(step_x):
            x = tc[0][0]
            while x < tc[0][1]:
                yield x
                x = (x // step_x + 1) * step_x

        if prog == mk.PGOD_RPCL:
            for reslevelno in range(codsty.nreslevels):
                step_x, step_y = step_of(range(ncomponents), [reslevelno])
                for y in ypos_iter(step_y):
                    for x in xpos_iter(step_x):
                        for compno in range(ncomponents):
                            precno = precinct_at(compno, reslevelno, x, y)
                            if precno is None:
                                continue
                            for layno in range(nlayers):
                                emit(compno, reslevelno, precno, layno)
        elif prog == mk.PGOD_PCRL:
            step_x, step_y = step_of(range(ncomponents),
                                     range(codsty.nreslevels))
            for y in ypos_iter(step_y):
                for x in xpos_iter(step_x):
                    for compno in range(ncomponents):
                        for reslevelno in range(codsty.nreslevels):
                            precno = precinct_at(compno, reslevelno, x, y)
                            if precno is None:
                                continue
                            for layno in range(nlayers):
                                emit(compno, reslevelno, precno, layno)
        elif prog == mk.PGOD_CPRL:
            for compno in range(ncomponents):
                step_x, step_y = step_of([compno], range(codsty.nreslevels))
                for y in ypos_iter(step_y):
                    for x in xpos_iter(step_x):
                        for reslevelno in range(codsty.nreslevels):
                            precno = precinct_at(compno, reslevelno, x, y)
                            if precno is None:
                                continue
                            for layno in range(nlayers):
                                emit(compno, reslevelno, precno, layno)
        else:
            raise ValueError(f"unknown progression {prog}")
