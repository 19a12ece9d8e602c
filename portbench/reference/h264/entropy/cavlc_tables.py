"""CAVLC VLC code tables (ITU-T H.264 Tables 9-5, 9-7, 9-8, 9-9, 9-10).

Stored in *encode* form — (length, codeword) per symbol — with decode
lookup tables derived programmatically by :func:`build_vlc_lut`.  The
reference instead hand-unrolls per-table decode switch code
(``hl_codec_264_cavlc.c:173-424``); deriving decode from the canonical spec
tables keeps a single source of truth.

Layout notes:
- ``COEFF_TOKEN_*[ctx][T1][TC]``: ctx 0..2 selects the VLC for nC in
  [0,2), [2,4), [4,8); nC >= 8 uses a 6-bit FLC; TC=0 valid only with T1=0.
- ``COEFF_TOKEN_CDC_*[T1][TC]``: nC == -1 (chroma DC, 4:2:0).
- ``TOTAL_ZEROS_*[TC-1][tz]`` for 4x4 blocks (TC 1..15).
- ``TOTAL_ZEROS_CDC_*[TC-1][tz]`` for 2x2 chroma DC (TC 1..3).
- ``RUN_BEFORE_*[min(zerosLeft,7)-1][run]``; for zerosLeft > 6 runs 7..14
  use (run-3)-bit codes '0..01'.
"""
from __future__ import annotations

import numpy as np

# Table 9-5 (coeff_token), contexts 0..2: value pairs are (len, code),
# indexed [ctx][TrailingOnes][TotalCoeff].
_CT = [
    [  # ctx 0: 0 <= nC < 2
        [(1, 1), (6, 5), (8, 7), (9, 7), (10, 7), (11, 7), (13, 15), (13, 11),
         (13, 8), (14, 15), (14, 11), (15, 15), (15, 11), (16, 15), (16, 11),
         (16, 7), (16, 4)],
        [(0, 0), (2, 1), (6, 4), (8, 6), (9, 6), (10, 6), (11, 6), (13, 14),
         (13, 10), (14, 14), (14, 10), (15, 14), (15, 10), (15, 1), (16, 14),
         (16, 10), (16, 6)],
        [(0, 0), (0, 0), (3, 1), (7, 5), (8, 5), (9, 5), (10, 5), (11, 5),
         (13, 13), (13, 9), (14, 13), (14, 9), (15, 13), (15, 9), (16, 13),
         (16, 9), (16, 5)],
        [(0, 0), (0, 0), (0, 0), (5, 3), (6, 3), (7, 4), (8, 4), (9, 4),
         (10, 4), (11, 4), (13, 12), (14, 12), (14, 8), (15, 12), (15, 8),
         (16, 12), (16, 8)],
    ],
    [  # ctx 1: 2 <= nC < 4
        [(2, 3), (6, 11), (6, 7), (7, 7), (8, 7), (8, 4), (9, 7), (11, 15),
         (11, 11), (12, 15), (12, 11), (12, 8), (13, 15), (13, 11), (13, 7),
         (14, 9), (14, 7)],
        [(0, 0), (2, 2), (5, 7), (6, 10), (6, 6), (7, 6), (8, 6), (9, 6),
         (11, 14), (11, 10), (12, 14), (12, 10), (13, 14), (13, 10), (14, 11),
         (14, 8), (14, 6)],
        [(0, 0), (0, 0), (3, 3), (6, 9), (6, 5), (7, 5), (8, 5), (9, 5),
         (11, 13), (11, 9), (12, 13), (12, 9), (13, 13), (13, 9), (13, 6),
         (14, 10), (14, 5)],
        [(0, 0), (0, 0), (0, 0), (4, 5), (4, 4), (5, 6), (6, 8), (6, 4),
         (7, 4), (9, 4), (11, 12), (11, 8), (12, 12), (13, 12), (13, 8),
         (13, 1), (14, 4)],
    ],
    [  # ctx 2: 4 <= nC < 8
        [(4, 15), (6, 15), (6, 11), (6, 8), (7, 15), (7, 11), (7, 9), (7, 8),
         (8, 15), (8, 11), (9, 15), (9, 11), (9, 8), (10, 13), (10, 9),
         (10, 5), (10, 1)],
        [(0, 0), (4, 14), (5, 15), (5, 12), (5, 10), (5, 8), (6, 14), (6, 10),
         (7, 14), (8, 14), (8, 10), (9, 14), (9, 10), (9, 7), (10, 12),
         (10, 8), (10, 4)],
        [(0, 0), (0, 0), (4, 13), (5, 14), (5, 11), (5, 9), (6, 13), (6, 9),
         (7, 13), (7, 10), (8, 13), (8, 9), (9, 13), (9, 9), (10, 11),
         (10, 7), (10, 3)],
        [(0, 0), (0, 0), (0, 0), (4, 12), (4, 11), (4, 10), (4, 9), (4, 8),
         (5, 13), (6, 12), (7, 12), (8, 12), (8, 8), (9, 12), (10, 10),
         (10, 6), (10, 2)],
    ],
]
COEFF_TOKEN_LEN = np.array([[[e[0] for e in row] for row in ctx]
                            for ctx in _CT], dtype=np.int32)
COEFF_TOKEN_VAL = np.array([[[e[1] for e in row] for row in ctx]
                            for ctx in _CT], dtype=np.int32)

# Table 9-5, nC == -1 (chroma DC, ChromaArrayType 1): [T1][TC] -> (len, code).
_CT_CDC = [
    [(2, 1), (6, 7), (6, 4), (6, 3), (6, 2)],
    [(0, 0), (1, 1), (6, 6), (7, 3), (8, 3)],
    [(0, 0), (0, 0), (3, 1), (7, 2), (8, 2)],
    [(0, 0), (0, 0), (0, 0), (6, 5), (7, 0)],
]
COEFF_TOKEN_CDC_LEN = np.array([[e[0] for e in row] for row in _CT_CDC],
                               dtype=np.int32)
COEFF_TOKEN_CDC_VAL = np.array([[e[1] for e in row] for row in _CT_CDC],
                               dtype=np.int32)

# Tables 9-7 / 9-8 (total_zeros, 4x4): [TotalCoeff-1][total_zeros].
TOTAL_ZEROS_LEN = np.zeros((15, 16), dtype=np.int32)
TOTAL_ZEROS_VAL = np.zeros((15, 16), dtype=np.int32)
_TZ_LEN = [
    [1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9],
    [3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6],
    [4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6],
    [5, 3, 4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5],
    [4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4, 5],
    [6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6],
    [6, 5, 3, 3, 3, 2, 3, 4, 3, 6],
    [6, 4, 5, 3, 2, 2, 3, 3, 6],
    [6, 6, 4, 2, 2, 3, 2, 5],
    [5, 5, 3, 2, 2, 2, 4],
    [4, 4, 3, 3, 1, 3],
    [4, 4, 2, 1, 3],
    [3, 3, 1, 2],
    [2, 2, 1],
    [1, 1],
]
_TZ_VAL = [
    [1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1],
    [7, 6, 5, 4, 3, 5, 4, 3, 2, 3, 2, 3, 2, 1, 0],
    [5, 7, 6, 5, 4, 3, 4, 3, 2, 3, 2, 1, 1, 0],
    [3, 7, 5, 4, 6, 5, 4, 3, 3, 2, 2, 1, 0],
    [5, 4, 3, 7, 6, 5, 4, 3, 2, 1, 1, 0],
    [1, 1, 7, 6, 5, 4, 3, 2, 1, 1, 0],
    [1, 1, 5, 4, 3, 3, 2, 1, 1, 0],
    [1, 1, 1, 3, 3, 2, 2, 1, 0],
    [1, 0, 1, 3, 2, 1, 1, 1],
    [1, 0, 1, 3, 2, 1, 1],
    [0, 1, 1, 2, 1, 3],
    [0, 1, 1, 1, 1],
    [0, 1, 1, 1],
    [0, 1, 1],
    [0, 1],
]
for _i, (_lens, _vals) in enumerate(zip(_TZ_LEN, _TZ_VAL)):
    TOTAL_ZEROS_LEN[_i, :len(_lens)] = _lens
    TOTAL_ZEROS_VAL[_i, :len(_vals)] = _vals

# Table 9-9(a) (total_zeros, chroma DC 2x2): [TotalCoeff-1][total_zeros].
TOTAL_ZEROS_CDC_LEN = np.array([[1, 2, 3, 3],
                                [1, 2, 2, 0],
                                [1, 1, 0, 0]], dtype=np.int32)
TOTAL_ZEROS_CDC_VAL = np.array([[1, 1, 1, 0],
                                [1, 1, 0, 0],
                                [1, 0, 0, 0]], dtype=np.int32)

# Table 9-10 (run_before): [min(zerosLeft,7)-1][run_before] -> (len, code).
# For zerosLeft > 6 only runs 0..6 are tabulated; runs 7..14 use the
# open-ended code (run-3 zeros... i.e. length run-3, value 1).
RUN_BEFORE_LEN = np.zeros((7, 15), dtype=np.int32)
RUN_BEFORE_VAL = np.zeros((7, 15), dtype=np.int32)
_RB = [
    [(1, 1), (1, 0)],
    [(1, 1), (2, 1), (2, 0)],
    [(2, 3), (2, 2), (2, 1), (2, 0)],
    [(2, 3), (2, 2), (2, 1), (3, 1), (3, 0)],
    [(2, 3), (2, 2), (3, 3), (3, 2), (3, 1), (3, 0)],
    [(2, 3), (3, 0), (3, 1), (3, 3), (3, 2), (3, 5), (3, 4)],
    [(3, 7), (3, 6), (3, 5), (3, 4), (3, 3), (3, 2), (3, 1),
     (4, 1), (5, 1), (6, 1), (7, 1), (8, 1), (9, 1), (10, 1), (11, 1)],
]
for _i, _row in enumerate(_RB):
    for _j, (_l, _v) in enumerate(_row):
        RUN_BEFORE_LEN[_i, _j] = _l
        RUN_BEFORE_VAL[_i, _j] = _v


def build_vlc_lut(lens: np.ndarray, vals: np.ndarray, symbols=None):
    """Build a prefix-decode LUT from (len, code) tables.

    Returns (lut_sym, lut_len, maxlen): peek ``maxlen`` bits -> symbol index
    (row-major over the table shape, or ``symbols`` entries) + code length.
    Entries with len == 0 are invalid/absent codes.
    """
    lens_f = lens.reshape(-1)
    vals_f = vals.reshape(-1)
    maxlen = int(lens_f.max())
    size = 1 << maxlen
    lut_sym = np.full(size, -1, dtype=np.int32)
    lut_len = np.zeros(size, dtype=np.int32)
    for idx in range(lens_f.size):
        ln = int(lens_f[idx])
        if ln == 0:
            continue
        code = int(vals_f[idx])
        base = code << (maxlen - ln)
        span = 1 << (maxlen - ln)
        sym = symbols[idx] if symbols is not None else idx
        lut_sym[base:base + span] = sym
        lut_len[base:base + span] = ln
    return lut_sym, lut_len, maxlen


# --- decode LUTs (derived) -------------------------------------------------

# coeff_token per context: symbol = TotalCoeff * 4 + TrailingOnes.
_ct_syms = np.array([[tc * 4 + t1 for tc in range(17)] for t1 in range(4)],
                    dtype=np.int32).reshape(-1)
COEFF_TOKEN_LUT = [
    build_vlc_lut(COEFF_TOKEN_LEN[c], COEFF_TOKEN_VAL[c], _ct_syms)
    for c in range(3)
]
_cdc_syms = np.array([[tc * 4 + t1 for tc in range(5)] for t1 in range(4)],
                     dtype=np.int32).reshape(-1)
COEFF_TOKEN_CDC_LUT = build_vlc_lut(COEFF_TOKEN_CDC_LEN, COEFF_TOKEN_CDC_VAL,
                                    _cdc_syms)

TOTAL_ZEROS_LUT = [build_vlc_lut(TOTAL_ZEROS_LEN[tc], TOTAL_ZEROS_VAL[tc])
                   for tc in range(15)]
TOTAL_ZEROS_CDC_LUT = [build_vlc_lut(TOTAL_ZEROS_CDC_LEN[tc],
                                     TOTAL_ZEROS_CDC_VAL[tc])
                       for tc in range(3)]
RUN_BEFORE_LUT = [build_vlc_lut(RUN_BEFORE_LEN[z], RUN_BEFORE_VAL[z])
                  for z in range(7)]
