"""The HTJ2K tables that the cleanup encoder inverts.

- CxtVLC decode tables: the Rec. ITU-T T.814 Annex C context-VLC codebook in
  decoded-LUT form (1024 entries = 128 codeword prefixes x 8 contexts), one
  table for the initial quad row and one for non-initial rows, from the
  blob `_cxtvlc.npz`. Entry layout (packed u16, parity with
  jpeg2000htdec.c:301-331): bits0: res_off, bits1-3: len, bits4-7: sig_pat,
  bits8-11: emb_pat_k, bits12-15: emb_pat_1.
- U-VLC prefix decode tables (T.814 7.3.6; jpeg2000htdec.c:340-341).
"""

import os

import numpy as np

_here = os.path.dirname(__file__)
_z = np.load(os.path.join(_here, "_cxtvlc.npz"))

CXTVLC_PACKED = np.stack([_z["table0"], _z["table1"]])  # [2, 1024] u16

# U-VLC prefix: value/drop-bits by 3 peeked bits (T.814 7.3.6)
UVLC_PREFIX_VALUE = np.array([5, 1, 2, 1, 3, 1, 2, 1], dtype=np.uint8)
UVLC_PREFIX_DROP = np.array([3, 1, 2, 1, 3, 1, 2, 1], dtype=np.uint8)
