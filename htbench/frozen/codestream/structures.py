"""Codestream header structures (SIZ/COD/QCD/CAP/POC) as dataclasses.

Semantics parity: ffmpeg's libavcodec/jpeg2000dec.c:197-818 (marker
readers) and jpeg2000.h:125-241 (structs). Representation is our own: plain
dataclasses the host parser fills in, consumed by geometry.py to build the
static codeblock grid that keys the jitted device pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from htbench.frozen.codestream import markers as mk


@dataclass
class ComponentInfo:
    depth: int       # bit depth (Ssiz & 0x7f) + 1
    sgnd: bool       # Ssiz & 0x80
    dx: int          # XRsiz
    dy: int          # YRsiz


@dataclass
class SIZ:
    rsiz: int = 0
    width: int = 0
    height: int = 0
    x0: int = 0
    y0: int = 0
    tile_width: int = 0
    tile_height: int = 0
    tx0: int = 0
    ty0: int = 0
    components: List[ComponentInfo] = field(default_factory=list)

    @property
    def ncomponents(self) -> int:
        return len(self.components)

    @property
    def num_x_tiles(self) -> int:
        return -(-(self.width - self.tx0) // self.tile_width)

    @property
    def num_y_tiles(self) -> int:
        return -(-(self.height - self.ty0) // self.tile_height)

    @property
    def precision(self) -> int:
        return max(c.depth for c in self.components)


@dataclass
class HTCaps:
    """Decoded CAP/Ccap15 bits (T.814; jpeg2000dec.c:424-489)."""
    is_ht: bool = False
    mode: int = mk.HT_HTONLY   # bits 14-15: HTONLY / HTDECLARED / MIXED
    rgn_allowed: bool = False  # bit 12 (RGNFREE when 0)
    heterogeneous: bool = False  # bit 11 (HOMOGENEOUS when 0)
    htrev: bool = False        # bit 5 (0 -> HTREV: reversible only)
    magb: int = 8              # B, derived from bits 0-4 (jpeg2000dec.c:473-481)


@dataclass
class CodingStyle:
    """COD/COC contents for one component (jpeg2000.h:137-153)."""
    csty: int = 0
    prog_order: int = mk.PGOD_LRCP
    nlayers: int = 1
    mct: int = 0
    nreslevels: int = 1
    nreslevels2decode: int = 1
    log2_cblk_width: int = 6
    log2_cblk_height: int = 6
    cblk_style: int = 0
    transform: int = mk.DWT53
    log2_prec_widths: List[int] = field(default_factory=lambda: [15] * mk.MAX_RESLEVELS)
    log2_prec_heights: List[int] = field(default_factory=lambda: [15] * mk.MAX_RESLEVELS)
    init: bool = False

    def copy(self) -> "CodingStyle":
        c = CodingStyle(**{k: v for k, v in self.__dict__.items()
                           if k not in ("log2_prec_widths", "log2_prec_heights")})
        c.log2_prec_widths = list(self.log2_prec_widths)
        c.log2_prec_heights = list(self.log2_prec_heights)
        return c


@dataclass
class QuantStyle:
    """QCD/QCC contents for one component (jpeg2000.h:155-161)."""
    nguardbits: int = 0
    quantsty: int = mk.QSTY_NONE
    expn: List[int] = field(default_factory=lambda: [0] * (mk.MAX_DECLEVELS * 3))
    mant: List[int] = field(default_factory=lambda: [0] * (mk.MAX_DECLEVELS * 3))

    def copy(self) -> "QuantStyle":
        q = QuantStyle(nguardbits=self.nguardbits, quantsty=self.quantsty)
        q.expn = list(self.expn)
        q.mant = list(self.mant)
        return q


@dataclass
class POCEntry:
    rspoc: int
    cspoc: int
    lyepoc: int
    repoc: int
    cepoc: int
    ppoc: int


@dataclass
class POC:
    entries: List[POCEntry] = field(default_factory=list)
    is_default: bool = False

    def copy(self) -> "POC":
        p = POC(entries=list(self.entries), is_default=self.is_default)
        return p


@dataclass
class TilePart:
    """One SOT..SOD..data unit. `data` is the post-SOD byte payload."""
    tile_index: int
    tp_index: int
    data: bytes
    ppm_header: Optional[bytes] = None  # packed header bytes when PPM present


@dataclass
class TileHeader:
    """Per-tile state accumulated from tile-part headers."""
    codsty: List[CodingStyle] = field(default_factory=list)
    qntsty: List[QuantStyle] = field(default_factory=list)
    poc: POC = field(default_factory=POC)
    tile_parts: List[TilePart] = field(default_factory=list)
    packed_headers: bytes = b""  # PPT payload
    has_ppt: bool = False
    roi_shift: List[int] = field(default_factory=list)
    plt_lengths: List[int] = field(default_factory=list)  # PLT (A.7.3):
    # per-packet byte lengths in stream order (SOP/EPH included)


@dataclass
class MainHeader:
    """Everything parsed from the main header + tile-part headers."""
    siz: SIZ = field(default_factory=SIZ)
    caps: HTCaps = field(default_factory=HTCaps)
    codsty: List[CodingStyle] = field(default_factory=list)
    qntsty: List[QuantStyle] = field(default_factory=list)
    poc: POC = field(default_factory=POC)
    tiles: List[TileHeader] = field(default_factory=list)
    roi_shift: List[int] = field(default_factory=list)
    packed_headers: bytes = b""  # PPM payload
    has_ppm: bool = False
    colour_space: int = 0   # from JP2 colr box (16=sRGB 17=gray 18=sYCC)
    palette: Optional[list] = None
    cdef: Optional[List[int]] = None
    sar: Optional[tuple] = None
    bitexact: bool = False  # decoder flag: forces DWT97 -> DWT97_INT
    reduction_factor: int = 0
    # tile parts in codestream (SOD) order — PPM header slices are consumed
    # in this order (jpeg2000dec.c:2467-2473)
    tile_part_order: List[TilePart] = field(default_factory=list)
    # TLM random access (jpeg2000dec.c:901-930): (Ttlm|None, Ptlm) per
    # tile-part, in codestream order; only_tile activates skip-parsing
    # (tile-parts of other tiles are seeked over, tlm_skipped counts the
    # bytes never touched)
    tlm_records: List = field(default_factory=list)
    only_tile: Optional[int] = None
    tlm_skipped: int = 0
