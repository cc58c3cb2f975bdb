"""Standard constant tables for HTJ2K and JPEG 2000 entropy coding.

- CxtVLC decode tables: the Rec. ITU-T T.814 Annex C context-VLC codebook in
  decoded-LUT form (1024 entries = 128 codeword prefixes x 8 contexts), one
  table for the initial quad row and one for non-initial rows. The blob
  `_cxtvlc.npz` is GENERATED from the human-readable Annex C codeword list
  by tools/gen_cxtvlc.py (run with --check to verify provenance) and
  decomposed here into per-field u8 arrays
  for vectorized gather on TPU. Entry layout (packed u16, parity with
  jpeg2000htdec.c:301-331): bits0: res_off, bits1-3: len, bits4-7: sig_pat,
  bits8-11: emb_pat_k, bits12-15: emb_pat_1.
- MEL exponent table (T.814 Table 4; jpeg2000htdec.c:68).
- MQ coder probability state machine (T.800 Table C.2; mqc.c:33-45).
- U-VLC prefix decode tables (T.814 7.3.6; jpeg2000htdec.c:340-341).
"""

import os

import numpy as np

_here = os.path.dirname(__file__)
_z = np.load(os.path.join(_here, "_cxtvlc.npz"))

CXTVLC_PACKED = np.stack([_z["table0"], _z["table1"]])  # [2, 1024] u16

# decomposed fields, indexed [initial_row(0)/non_initial(1), code]
CXTVLC_LEN = ((CXTVLC_PACKED & 0xF) >> 1).astype(np.uint8)
CXTVLC_RES_OFF = (CXTVLC_PACKED & 1).astype(np.uint8)
CXTVLC_SIG_PAT = ((CXTVLC_PACKED >> 4) & 0xF).astype(np.uint8)
CXTVLC_EMB_K = ((CXTVLC_PACKED >> 8) & 0xF).astype(np.uint8)
CXTVLC_EMB_1 = ((CXTVLC_PACKED >> 12) & 0xF).astype(np.uint8)

# MEL run-length exponent per state (T.814; jpeg2000htdec.c:68)
MEL_E = np.array([0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5], dtype=np.uint8)

# U-VLC prefix: value/drop-bits by 3 peeked bits (T.814 7.3.6)
UVLC_PREFIX_VALUE = np.array([5, 1, 2, 1, 3, 1, 2, 1], dtype=np.uint8)
UVLC_PREFIX_DROP = np.array([3, 1, 2, 1, 3, 1, 2, 1], dtype=np.uint8)

# MQ coder state machine (ISO 15444-1 Table C.2). States are doubled to
# carry the MPS bit in bit 0 (parity with mqc.c:33-45).
MQ_QE = np.array([
    0x5601, 0x5601, 0x3401, 0x3401, 0x1801, 0x1801, 0x0AC1, 0x0AC1,
    0x0521, 0x0521, 0x0221, 0x0221, 0x5601, 0x5601, 0x5401, 0x5401,
    0x4801, 0x4801, 0x3801, 0x3801, 0x3001, 0x3001, 0x2401, 0x2401,
    0x1C01, 0x1C01, 0x1601, 0x1601, 0x5601, 0x5601, 0x5401, 0x5401,
    0x5101, 0x5101, 0x4801, 0x4801, 0x3801, 0x3801, 0x3401, 0x3401,
    0x3001, 0x3001, 0x2801, 0x2801, 0x2401, 0x2401, 0x2201, 0x2201,
    0x1C01, 0x1C01, 0x1801, 0x1801, 0x1601, 0x1601, 0x1401, 0x1401,
    0x1201, 0x1201, 0x1101, 0x1101, 0x0AC1, 0x0AC1, 0x09C1, 0x09C1,
    0x08A1, 0x08A1, 0x0521, 0x0521, 0x0441, 0x0441, 0x02A1, 0x02A1,
    0x0221, 0x0221, 0x0141, 0x0141, 0x0111, 0x0111, 0x0085, 0x0085,
    0x0049, 0x0049, 0x0025, 0x0025, 0x0015, 0x0015, 0x0009, 0x0009,
    0x0005, 0x0005, 0x0001, 0x0001, 0x5601, 0x5601,
], dtype=np.uint16)

MQ_NLPS = np.array([
    3, 2, 12, 13, 18, 19, 24, 25, 58, 59, 66, 67, 13, 12, 28, 29,
    28, 29, 28, 29, 34, 35, 36, 37, 40, 41, 42, 43, 29, 28, 28, 29,
    30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59,
    60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75,
    76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 92, 93,
], dtype=np.uint8)

MQ_NMPS = np.array([
    2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 76, 77, 14, 15, 16, 17,
    18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 58, 59, 30, 31, 32, 33,
    34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49,
    50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65,
    66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81,
    82, 83, 84, 85, 86, 87, 88, 89, 90, 91, 90, 91, 92, 93,
], dtype=np.uint8)

MQC_CX_UNI = 17
MQC_CX_RL = 18


def mq_initial_cx_states() -> np.ndarray:
    """Initial context states (mqc.c:62-67)."""
    cx = np.zeros(19, dtype=np.uint8)
    cx[MQC_CX_UNI] = 2 * 46
    cx[MQC_CX_RL] = 2 * 3
    cx[0] = 2 * 4
    return cx
