"""Main-header / tile-part-header marker parser and JP2 box walker.

Behavior parity: jpeg2000_read_main_headers (jpeg2000dec.c:2425-2637),
get_siz/get_cap/get_cod/get_coc/get_qcd/get_qcc/get_rgn/get_poc/get_sot
(jpeg2000dec.c:197-873) and jp2_find_codestream (jpeg2000dec.c:2658-2805).

The output is a fully-populated MainHeader with per-tile coding/quant styles
and tile-part payload slices — everything T2 needs. Parsing is pure host-side
Python; it never touches JAX.
"""

from __future__ import annotations

from ffmpeg_ht_tpu_torch.codestream import markers as mk
from ffmpeg_ht_tpu_torch.codestream.bitio import ByteReader
from ffmpeg_ht_tpu_torch.codestream.structures import (CodingStyle, ComponentInfo,
                                                 HTCaps, MainHeader, POC,
                                                 POCEntry, QuantStyle, SIZ,
                                                 TileHeader, TilePart)
from ffmpeg_ht_tpu_torch.utils.errors import InvalidData, PatchWelcome
from ffmpeg_ht_tpu_torch.utils.log import logger

HAD_COC = 0x01
HAD_QCC = 0x02
MAX_TILE_PARTS = 256


def _get_siz(g: ByteReader, hdr: MainHeader) -> None:
    if g.bytes_left() < 36:
        raise InvalidData("Insufficient space for SIZ")
    siz = SIZ()
    siz.rsiz = g.u16()
    siz.width = g.u32()
    siz.height = g.u32()
    siz.x0 = g.u32()
    siz.y0 = g.u32()
    siz.tile_width = g.u32()
    siz.tile_height = g.u32()
    siz.tx0 = g.u32()
    siz.ty0 = g.u32()
    ncomp = g.u16()

    if ncomp <= 0:
        raise InvalidData("Invalid number of components")
    if ncomp > 4:
        raise PatchWelcome(f"{ncomp} components")
    if (siz.tx0 < 0 or siz.ty0 < 0 or siz.x0 < siz.tx0 or siz.y0 < siz.ty0
            or siz.tile_width + siz.tx0 <= siz.x0
            or siz.tile_height + siz.ty0 <= siz.y0):
        raise InvalidData("Tile offsets are invalid")
    if siz.x0 >= siz.width or siz.y0 >= siz.height:
        raise InvalidData("image offsets outside image")
    if siz.tile_width <= 0 or siz.tile_height <= 0:
        raise InvalidData("Invalid tile dimensions")
    if g.bytes_left() < 3 * ncomp:
        raise InvalidData("Insufficient space for SIZ components")

    for _ in range(ncomp):
        x = g.u8()
        depth = (x & 0x7F) + 1
        sgnd = bool(x & 0x80)
        dx = g.u8()
        dy = g.u8()
        if dx == 0 or dx == 3 or dx > 4 or dy == 0 or dy == 3 or dy > 4:
            raise InvalidData("Invalid sample separation")
        siz.components.append(ComponentInfo(depth, sgnd, dx, dy))

    hdr.siz = siz
    hdr.codsty = [CodingStyle() for _ in range(ncomp)]
    hdr.qntsty = [QuantStyle() for _ in range(ncomp)]
    hdr.roi_shift = [0] * ncomp
    hdr.tiles = [TileHeader() for _ in range(siz.num_x_tiles * siz.num_y_tiles)]


def _get_cap(g: ByteReader, hdr: MainHeader) -> None:
    """CAP marker / Ccap15 (T.814; jpeg2000dec.c:424-489)."""
    if g.bytes_left() < 6:
        raise InvalidData("Underflow in CAP")
    pcap = g.u32()
    ccap = {}
    for i in range(32):
        if (pcap >> (31 - i)) & 1:
            ccap[i + 1] = g.u16()
    caps = hdr.caps
    caps.is_ht = bool((pcap >> (31 - 14)) & 1)
    if caps.is_ht:
        c15 = ccap.get(15, 0)
        mode = (c15 >> 14) & 3
        if mode == 2:
            raise InvalidData("Unknown Ccap15 bits 14-15")
        caps.mode = mode
        if (c15 >> 13) & 1:
            raise PatchWelcome("MULTIHT set")
        caps.rgn_allowed = bool((c15 >> 12) & 1)
        caps.heterogeneous = bool((c15 >> 11) & 1)
        caps.htrev = bool((c15 >> 5) & 1)
        p = c15 & 0x1F
        if p == 0:
            caps.magb = 8
        elif p < 20:
            caps.magb = p + 8
        elif p < 31:
            caps.magb = 4 * (p - 19) + 27
        else:
            caps.magb = 74
        if caps.magb > 31:
            raise PatchWelcome("B > 31")


def _get_cox(g: ByteReader, c: CodingStyle, hdr: MainHeader) -> None:
    if g.bytes_left() < 5:
        raise InvalidData("Insufficient space for COX")
    c.nreslevels = g.u8() + 1
    if c.nreslevels >= mk.MAX_RESLEVELS:
        raise InvalidData("nreslevels invalid")
    if c.nreslevels <= hdr.reduction_factor:
        raise InvalidData("reduction_factor too large for this bitstream")
    c.nreslevels2decode = c.nreslevels - hdr.reduction_factor

    c.log2_cblk_width = (g.u8() & 15) + 2
    c.log2_cblk_height = (g.u8() & 15) + 2
    if (c.log2_cblk_width > 10 or c.log2_cblk_height > 10
            or c.log2_cblk_width + c.log2_cblk_height > 12):
        raise InvalidData("cblk size invalid")

    c.cblk_style = g.u8()
    c.transform = g.u8()
    if c.transform > 1:
        # spec allows 0 (9/7) or 1 (5/3) only; the reference rejects other
        # values in ff_jpeg2000_dwt_init (jpeg2000dwt.c:543-546)
        raise InvalidData(f"DWT transform type {c.transform} invalid")
    if hdr.bitexact and c.transform == mk.DWT97:
        c.transform = mk.DWT97_INT

    if c.csty & mk.CSTY_PREC:
        for i in range(c.nreslevels):
            byte = g.u8()
            c.log2_prec_widths[i] = byte & 0x0F
            c.log2_prec_heights[i] = (byte >> 4) & 0x0F
            if i and (c.log2_prec_widths[i] == 0 or c.log2_prec_heights[i] == 0):
                raise InvalidData("PPx/PPy invalid")
    else:
        for i in range(mk.MAX_RESLEVELS):
            c.log2_prec_widths[i] = 15
            c.log2_prec_heights[i] = 15


def _get_cod(g: ByteReader, hdr: MainHeader, codsty: list, properties: list) -> None:
    if g.bytes_left() < 5:
        raise InvalidData("Insufficient space for COD")
    tmp = CodingStyle()
    tmp.csty = g.u8()
    tmp.prog_order = g.u8()
    tmp.nlayers = g.u16()
    tmp.mct = g.u8()
    if tmp.mct and hdr.siz.ncomponents < 3:
        raise InvalidData("MCT with too few components")
    _get_cox(g, tmp, hdr)
    tmp.init = True
    for compno in range(hdr.siz.ncomponents):
        if not (properties[compno] & HAD_COC):
            codsty[compno] = tmp.copy()


def _get_coc(g: ByteReader, hdr: MainHeader, codsty: list, properties: list) -> None:
    if g.bytes_left() < 2:
        raise InvalidData("Insufficient space for COC")
    compno = g.u8()
    if compno >= hdr.siz.ncomponents:
        raise InvalidData("Invalid COC compno")
    c = codsty[compno]
    has_eph = c.csty & mk.CSTY_EPH
    has_sop = c.csty & mk.CSTY_SOP
    c.csty = g.u8() | has_eph | has_sop
    _get_cox(g, c, hdr)
    properties[compno] |= HAD_COC
    c.init = True


def _get_qcx(g: ByteReader, n: int, q: QuantStyle) -> None:
    if g.bytes_left() < 1:
        raise InvalidData("QCX underflow")
    x = g.u8()
    q.nguardbits = x >> 5
    q.quantsty = x & 0x1F
    if q.quantsty == mk.QSTY_NONE:
        n -= 3
        if g.bytes_left() < n or n > mk.MAX_DECLEVELS * 3:
            raise InvalidData("QCX underflow")
        for i in range(n):
            q.expn[i] = g.u8() >> 3
    elif q.quantsty == mk.QSTY_SI:
        if g.bytes_left() < 2:
            raise InvalidData("QCX underflow")
        x = g.u16()
        q.expn[0] = x >> 11
        q.mant[0] = x & 0x7FF
        for i in range(1, mk.MAX_DECLEVELS * 3):
            q.expn[i] = max(0, q.expn[0] - (i - 1) // 3)
            q.mant[i] = q.mant[0]
    else:
        n = (n - 3) >> 1
        if g.bytes_left() < 2 * n or n > mk.MAX_DECLEVELS * 3:
            raise InvalidData("QCX underflow")
        for i in range(n):
            x = g.u16()
            q.expn[i] = x >> 11
            q.mant[i] = x & 0x7FF


def _get_qcd(g: ByteReader, n: int, hdr: MainHeader, qntsty: list,
             properties: list) -> None:
    tmp = QuantStyle()
    _get_qcx(g, n, tmp)
    for compno in range(hdr.siz.ncomponents):
        if not (properties[compno] & HAD_QCC):
            qntsty[compno] = tmp.copy()


def _get_qcc(g: ByteReader, n: int, hdr: MainHeader, qntsty: list,
             properties: list) -> None:
    if g.bytes_left() < 1:
        raise InvalidData("QCC underflow")
    compno = g.u8()
    if compno >= hdr.siz.ncomponents:
        raise InvalidData("Invalid QCC compno")
    properties[compno] |= HAD_QCC
    _get_qcx(g, n - 1, qntsty[compno])


def _get_rgn(g: ByteReader, n: int, hdr: MainHeader, curtileno: int) -> None:
    compno = g.u8() if hdr.siz.ncomponents < 257 else g.u16()
    if g.u8() != 0:
        raise InvalidData("Invalid RGN header (SRgn != 0)")
    if compno < hdr.siz.ncomponents:
        v = g.u8()
        if v > 30:
            raise PatchWelcome("ROI shift > 30")
        if curtileno == -1:
            hdr.roi_shift[compno] = v
        else:
            th = hdr.tiles[curtileno]
            if th.tile_parts and th.tile_parts[-1].tp_index != 0:
                raise InvalidData("RGN must be in first tile part")
            th.roi_shift[compno] = v
        return
    raise InvalidData("RGN compno out of range")


def _get_poc(g: ByteReader, size: int, hdr: MainHeader, poc: POC) -> None:
    ncomp = hdr.siz.ncomponents
    elem_size = 7 if ncomp <= 257 else 9
    if g.bytes_left() < 5 or size < 2 + elem_size:
        raise InvalidData("Insufficient space for POC")
    if elem_size > 7:
        raise PatchWelcome("Fat POC")
    nb_poc = (size - 2) // elem_size
    if nb_poc > 32:
        raise PatchWelcome("Too many POCs")
    entries = []
    for _ in range(nb_poc):
        e = POCEntry(rspoc=g.u8(), cspoc=g.u8(), lyepoc=g.u16(),
                     repoc=g.u8(), cepoc=g.u8(), ppoc=g.u8())
        if e.cepoc == 0:
            e.cepoc = 256
        e.cepoc = min(e.cepoc, ncomp)
        if (e.rspoc >= e.repoc or e.repoc > 33
                or e.cspoc >= e.cepoc or e.cepoc > ncomp or e.lyepoc == 0):
            raise InvalidData("POC entry invalid")
        entries.append(e)

    if not poc.entries or poc.is_default:
        poc.entries = entries
    else:
        if len(poc.entries) + len(entries) > 32:
            raise InvalidData("Insufficient space for POC")
        poc.entries.extend(entries)
    poc.is_default = False


def _get_sot(g: ByteReader, n: int, hdr: MainHeader) -> tuple:
    """Returns (tile_index, tp_index, tp_end_abs_pos)."""
    if g.bytes_left() < 8:
        raise InvalidData("SOT underflow")
    isot = g.u16()
    if isot >= len(hdr.tiles):
        raise InvalidData("Isot out of range")
    psot = g.u32()
    tpsot = g.u8()
    g.u8()  # TNsot, unused

    if psot == 0:
        psot = g.bytes_left() - 2 + n + 2
    if psot > g.bytes_left() - 2 + n + 2:
        raise InvalidData(f"Psot {psot} too big")
    if tpsot >= MAX_TILE_PARTS:
        raise PatchWelcome("Too many tile parts")

    tile = hdr.tiles[isot]
    if tpsot == 0:
        tile.codsty = [c.copy() for c in hdr.codsty]
        tile.qntsty = [q.copy() for q in hdr.qntsty]
        tile.poc = hdr.poc.copy()
        tile.poc.is_default = True
        tile.roi_shift = list(hdr.roi_shift)

    tp_end = g.tell() + psot - n - 2
    return isot, tpsot, tp_end


def _get_tlm(g: ByteReader, n: int, hdr: MainHeader) -> None:
    """Parse AND retain the tile-part length table (jpeg2000dec.c:901-930
    validates; retention powers the only_tile random access)."""
    g.u8()  # Ztlm
    stlm = g.u8()
    st = (stlm >> 4) & 0x03
    if st == 3:
        raise InvalidData("TLM invalid ST")
    sp = (stlm >> 6) & 0x01
    ntiles = (n - 4) // ((sp + 1) * 2 + st)
    for _ in range(ntiles):
        ttlm = None
        if st == 1:
            ttlm = g.u8()
        elif st == 2:
            ttlm = g.u16()
        ptlm = g.u16() if sp == 0 else g.u32()
        hdr.tlm_records.append((ttlm, ptlm))


def _get_plt(g: ByteReader, n: int, th=None) -> None:
    """Packet-length varints (T.800 A.7.3): 7 bits per byte, bit 7 set =
    continuation. Lengths accumulate on the tile header in stream order;
    decode_tile_packets uses them to skip discarded packets bytewise."""
    if n < 4:
        raise InvalidData("PLT too short")
    g.u8()  # Zplt
    v = 0
    acc = 0
    for _ in range(n - 3):
        v = g.u8()
        acc = (acc << 7) | (v & 0x7F)
        if not (v & 0x80):
            if th is not None:
                th.plt_lengths.append(acc)
            acc = 0
    if v & 0x80:
        raise InvalidData("PLT truncated mid-varint")


def parse_jp2_boxes(g: ByteReader, hdr: MainHeader) -> bool:
    """Walk JP2 boxes to the jp2c codestream (jpeg2000dec.c:2658-2805).

    Returns True when positioned at the codestream payload.
    """
    search_range = 10
    while search_range and g.bytes_left() >= 8:
        atom_size = g.u32()
        atom = g.u32()
        if atom_size == 1:
            if g.u32():
                return False  # huge atom unsupported
            atom_size = g.u32()
            if atom_size < 16:
                raise InvalidData("bad extended box size")
            atom_end = g.tell() + atom_size - 16
        else:
            if atom_size != 0 and atom_size < 8:
                raise InvalidData("bad box size")
            atom_end = g.tell() + atom_size - 8 if atom_size else g.end

        if atom == mk.JP2_CODESTREAM:
            return True
        if g.bytes_left() < atom_size or atom_end < atom_size:
            return False

        if atom == mk.JP2_HEADER and atom_size >= 16:
            while atom_end - g.tell() >= 8:
                if g.bytes_left() < 8:
                    break
                a2_size = g.u32()
                a2 = g.u32()
                a2_end = g.tell() + a2_size - 8
                if a2_size < 8 or a2_end > atom_end:
                    break
                a2_size -= 8
                if a2 == mk.JP2_CODESTREAM:
                    return True
                elif a2 == mk.tag("colr") and a2_size >= 7:
                    method = g.u8()
                    g.skip(2)
                    if method == 1:
                        hdr.colour_space = g.u32()
                elif a2 == mk.tag("pclr") and a2_size >= 6:
                    _parse_pclr(g, a2_size, a2_end, hdr)
                elif a2 == mk.tag("cdef") and a2_size >= 2:
                    nch = g.u16()
                    cdef = hdr.cdef if hdr.cdef else [-1, -1, -1, -1]
                    for _ in range(nch):
                        cn = g.u16()
                        g.u16()  # typ
                        asoc = g.u16()
                        if cn < 4 and asoc < 4:
                            cdef[cn] = asoc
                    hdr.cdef = cdef
                elif a2 == mk.tag("res ") and a2_size >= 18:
                    _parse_res(g, a2_end, hdr)
                g.seek(a2_end)
        else:
            search_range -= 1
        g.seek(atom_end)
    return False


def _parse_pclr(g: ByteReader, size: int, end: int, hdr: MainHeader) -> None:
    colour_count = g.u16()
    colour_channels = g.u8()
    depth = [(g.u8() & 0x7F) + 1 for _ in range(3)]
    total = sum((d + 7 >> 3) * colour_count for d in depth)
    if (colour_count > 256 or colour_channels != 3
            or any(d > 16 for d in depth) or size < total):
        g.seek(end)
        return
    pal = []
    for _ in range(colour_count):
        rgb = []
        for d in depth:
            if d <= 8:
                v = g.u8() << (8 - d)
                v |= v >> d
            else:
                v = g.u16() >> (d - 8)
            rgb.append(v)
        pal.append(0xFF000000 | (rgb[0] << 16) | (rgb[1] << 8) | rgb[2])
    hdr.palette = pal


def _parse_res(g: ByteReader, end: int, hdr: MainHeader) -> None:
    g.skip(4)
    resx = g.u32()
    if resx not in (mk.tag("resc"), mk.tag("resd")):
        g.seek(end)
        return
    vnum, vden, hnum, hden = g.u16(), g.u16(), g.u16(), g.u16()
    vexp, hexp = g.u8(), g.u8()
    if not (vnum and vden and hnum and hden):
        g.seek(end)
        return
    if vexp > hexp:
        vexp -= hexp
        hexp = 0
    else:
        hexp -= vexp
        vexp = 0
    hdr.sar = (hnum * vden * (10 ** hexp), vnum * hden * (10 ** vexp))


def parse_codestream(data: bytes, bitexact: bool = False,
                     reduction_factor: int = 0,
                     only_tile=None) -> MainHeader:
    """Parse a raw J2C codestream or JP2/JPH file into a MainHeader.

    Mirrors jpeg2000_decode_frame's header stage (jpeg2000dec.c:2825-2866) +
    jpeg2000_read_main_headers (jpeg2000dec.c:2425-2637).

    only_tile=k + a TLM marker: tile-parts of other tiles are seeked
    over without reading them (random access, jpeg2000dec.c:901-930);
    hdr.tlm_skipped reports the untouched byte count.
    """
    hdr = MainHeader()
    hdr.bitexact = bitexact
    hdr.reduction_factor = reduction_factor
    hdr.only_tile = only_tile
    g = ByteReader(data)

    if g.bytes_left() < 2:
        raise InvalidData("too short")

    # JP2 signature box?
    if (g.bytes_left() >= 12 and g.peek_u32() == 12):
        save = g.tell()
        if g.u32() == 12 and g.u32() == mk.JP2_SIG_TYPE and g.u32() == mk.JP2_SIG_VALUE:
            if not parse_jp2_boxes(g, hdr):
                raise InvalidData("Could not find JPEG 2000 codestream atom")
        else:
            g.seek(save)

    # scan for SOC
    while g.bytes_left() >= 3 and g.peek_u16() != mk.SOC:
        g.skip(1)
    if g.u16() != mk.SOC:
        raise InvalidData("SOC marker not present")

    _read_main_headers(g, hdr)
    if not hdr.siz.components:
        raise InvalidData("no SIZ / no components in codestream")
    if not hdr.tiles or not any(th.tile_parts for th in hdr.tiles):
        raise InvalidData("no tile-part data in codestream")
    return hdr


def _read_main_headers(g: ByteReader, hdr: MainHeader) -> None:
    codsty = hdr.codsty
    qntsty = hdr.qntsty
    poc = hdr.poc
    properties = [0, 0, 0, 0]
    in_tile_headers = False
    curtileno = -1
    cur_tp = None  # (isot, tpsot, tp_end)

    while True:
        if g.bytes_left() < 2:
            logger.error("Missing EOC")
            break
        marker = g.u16()
        oldpos = g.tell()
        if 0xFF30 <= marker <= 0xFF3F:
            continue
        if marker == mk.SOD:
            if not hdr.tiles:
                raise InvalidData("Missing SIZ")
            if curtileno < 0:
                raise InvalidData("Missing SOT")
            isot, tpsot, tp_end = cur_tp
            if tp_end < g.tell():
                raise InvalidData("Invalid tpend")
            tile = hdr.tiles[isot]
            payload = g.buf[g.tell():tp_end]
            tp = TilePart(tile_index=isot, tp_index=tpsot, data=payload)
            tile.tile_parts.append(tp)
            hdr.tile_part_order.append(tp)
            g.seek(tp_end)
            continue
        if marker == mk.EOC:
            break

        length = g.u16()
        if length < 2 or g.bytes_left() < length - 2:
            logger.warning("Missing EOC marker")
            break

        if marker == mk.SIZ:
            if hdr.siz.ncomponents:
                raise InvalidData("Duplicate SIZ")
            _get_siz(g, hdr)
            codsty = hdr.codsty
            qntsty = hdr.qntsty
        elif marker == mk.CAP:
            if not hdr.siz.ncomponents:
                raise InvalidData("CAP before SIZ")
            _get_cap(g, hdr)
        elif marker == mk.COD:
            _check_homogeneous(hdr, in_tile_headers, "COD")
            _get_cod(g, hdr, codsty, properties)
        elif marker == mk.COC:
            _check_homogeneous(hdr, in_tile_headers, "COC")
            _get_coc(g, hdr, codsty, properties)
        elif marker == mk.RGN:
            _check_homogeneous(hdr, in_tile_headers, "RGN")
            _get_rgn(g, length, hdr, curtileno)
            if hdr.caps.is_ht and not hdr.caps.rgn_allowed:
                raise InvalidData("RGN in RGNFREE HT set")
        elif marker == mk.QCD:
            _check_homogeneous(hdr, in_tile_headers, "QCD")
            _get_qcd(g, length, hdr, qntsty, properties)
        elif marker == mk.QCC:
            _check_homogeneous(hdr, in_tile_headers, "QCC")
            _get_qcc(g, length, hdr, qntsty, properties)
        elif marker == mk.POC:
            _check_homogeneous(hdr, in_tile_headers, "POC")
            _get_poc(g, length, hdr, poc)
        elif marker == mk.SOT:
            if not in_tile_headers:
                in_tile_headers = True
                if hdr.only_tile is not None and hdr.tlm_records:
                    # TLM random access: seek over every tile-part that
                    # does not belong to only_tile; those bytes are never
                    # read (jpeg2000dec.c:901-930 analog)
                    base = oldpos - 2
                    pos = base
                    for rec_i, (ttlm, ptlm) in \
                            enumerate(hdr.tlm_records):
                        t = ttlm if ttlm is not None else rec_i
                        if ptlm < 14:
                            raise InvalidData("TLM Ptlm too small")
                        if t != hdr.only_tile:
                            hdr.tlm_skipped += ptlm
                        else:
                            g.seek(pos + 2)
                            ln = g.u16()
                            isot, tpsot, tp_end = _get_sot(g, ln, hdr)
                            if isot != t:
                                raise InvalidData("TLM/Isot mismatch")
                            if g.u16() != mk.SOD:
                                raise InvalidData(
                                    "TLM tile-part without SOD")
                            tile = hdr.tiles[isot]
                            payload = g.buf[g.tell():tp_end]
                            tp = TilePart(tile_index=isot,
                                          tp_index=tpsot, data=payload)
                            tile.tile_parts.append(tp)
                            hdr.tile_part_order.append(tp)
                        pos += ptlm
                    g.seek(pos)
                    continue
            isot, tpsot, tp_end = _get_sot(g, length, hdr)
            curtileno = isot
            cur_tp = (isot, tpsot, tp_end)
            tile = hdr.tiles[isot]
            codsty = tile.codsty
            qntsty = tile.qntsty
            poc = tile.poc
            properties = [0, 0, 0, 0]
        elif marker in (mk.PLM, mk.COM):
            g.skip(length - 2)
        elif marker == mk.CRG:
            if hdr.siz.ncomponents * 4 != length - 2:
                raise InvalidData("Invalid CRG marker")
            g.skip(length - 2)
        elif marker == mk.TLM:
            _get_tlm(g, length, hdr)
        elif marker == mk.PLT:
            _get_plt(g, length,
                     hdr.tiles[curtileno] if curtileno >= 0 else None)
        elif marker == mk.PPM:
            if in_tile_headers:
                raise InvalidData("PPM must be in main header")
            if length < 3:
                raise InvalidData("Invalid PPM length")
            g.u8()  # Zppm
            hdr.packed_headers += g.read(length - 3)
            hdr.has_ppm = True
        elif marker == mk.PPT:
            if hdr.has_ppm:
                raise InvalidData("Cannot have both PPT and PPM")
            if hdr.caps.is_ht and not hdr.caps.heterogeneous:
                raise InvalidData("PPT in HOMOGENEOUS HT set")
            if length < 3 or curtileno < 0:
                raise InvalidData("Invalid PPT")
            tile = hdr.tiles[curtileno]
            if tile.tile_parts and tile.tile_parts[-1].tp_index != 0:
                raise InvalidData("PPT only in first tile part")
            g.u8()  # Zppt
            tile.packed_headers += g.read(length - 3)
            tile.has_ppt = True
        elif marker == mk.CPF:
            g.skip(length - 2)
        else:
            logger.error("unsupported marker 0x%04X", marker)
            g.skip(length - 2)

        if g.tell() - oldpos != length:
            raise InvalidData(f"error processing marker segment {marker:#06x}")


def _check_homogeneous(hdr: MainHeader, in_tile_headers: bool, name: str) -> None:
    if in_tile_headers and hdr.caps.is_ht and not hdr.caps.heterogeneous:
        raise InvalidData(f"{name} in tile header of HOMOGENEOUS HT codestream")
