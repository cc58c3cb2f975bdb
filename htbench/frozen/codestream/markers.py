"""JPEG 2000 codestream marker constants (Rec. ITU-T T.800 Annex A, T.814).

Values per the standard; usage parity with ffmpeg's libavcodec/jpeg2000.h:38-61.
"""

SOC = 0xFF4F  # start of codestream
CAP = 0xFF50  # extended capabilities (T.814 uses Ccap15)
SIZ = 0xFF51  # image and tile size
COD = 0xFF52  # coding style default
COC = 0xFF53  # coding style component
TLM = 0xFF55  # tile-part lengths, main header
PLM = 0xFF57  # packet lengths, main header
PLT = 0xFF58  # packet lengths, tile-part header
CPF = 0xFF59  # corresponding profile (T.814)
QCD = 0xFF5C  # quantization default
QCC = 0xFF5D  # quantization component
RGN = 0xFF5E  # region of interest
POC = 0xFF5F  # progression order change
PPM = 0xFF60  # packed packet headers, main header
PPT = 0xFF61  # packed packet headers, tile-part header
CRG = 0xFF63  # component registration
COM = 0xFF64  # comment
SOT = 0xFF90  # start of tile-part
SOP = 0xFF91  # start of packet
EPH = 0xFF92  # end of packet header
SOD = 0xFF93  # start of data
EOC = 0xFFD9  # end of codestream

SOP_FIXED_BYTES = 0xFF910004
SOP_BYTE_LENGTH = 6

# Progression orders (T.800 A.6.1)
PGOD_LRCP = 0
PGOD_RLCP = 1
PGOD_RPCL = 2
PGOD_PCRL = 3
PGOD_CPRL = 4

# Quantization styles (T.800 A.6.4)
QSTY_NONE = 0  # no quantization (reversible)
QSTY_SI = 1    # scalar derived
QSTY_SE = 2    # scalar expounded

# Coding style flags (Scod/Scoc)
CSTY_PREC = 0x01  # precinct sizes signalled
CSTY_SOP = 0x02   # SOP markers used
CSTY_EPH = 0x04   # EPH markers used

# Codeblock style flags (SPcod/SPcoc byte 5)
CBLK_BYPASS = 0x01
CBLK_RESET = 0x02
CBLK_TERMALL = 0x04
CBLK_VSC = 0x08
CBLK_PREDTERM = 0x10
CBLK_SEGSYM = 0x20
CTSY_HTJ2K_F = 0x40  # all code-blocks are HT (T.814)
CTSY_HTJ2K_M = 0xC0  # HT and legacy code-blocks can be mixed
HT_MIXED = 0x80      # bit 7 of cblk style: MIXED flag

# Transform types (SPcod byte: 0 = 9/7 irreversible, 1 = 5/3 reversible).
# We keep ffmpeg's internal third state for the bitexact integer 9/7 path
# (jpeg2000dec.c:542-544).
DWT97 = 0
DWT53 = 1
DWT97_INT = 2

# Ccap15 (T.814 capability sub-field) decoded modes
HT_HTONLY = 0
HT_HTDECLARED = 1
HT_MIXED_SET = 3

MAX_DECLEVELS = 33
MAX_RESLEVELS = MAX_DECLEVELS + 1
MAX_PASSES = 100

# JP2 box types
JP2_SIG_TYPE = 0x6A502020
JP2_SIG_VALUE = 0x0D0A870A
JP2_CODESTREAM = 0x6A703263  # 'jp2c'
JP2_HEADER = 0x6A703268      # 'jp2h'


def tag(s: str) -> int:
    """Four-character box tag to big-endian uint32."""
    return int.from_bytes(s.encode("latin1"), "big")
