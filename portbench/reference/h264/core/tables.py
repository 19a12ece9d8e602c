"""H.264 constant tables (ITU-T Rec. H.264 spec constants), as numpy arrays.

These are the standard-mandated numeric tables every H.264 codec carries;
the reference keeps them in ``hl_codec_264_tables.c/h`` (73 tables). Here they
are constructed programmatically where a closed form exists and verified
against the reference's values by ``tests/test_tables.py``.
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Scan orders
# ---------------------------------------------------------------------------

# 4x4 zig-zag scan (frame coding), spec 8.5.6: coeff index -> raster position.
ZIGZAG_4x4 = np.array([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15],
                      dtype=np.int32)
# Inverse: raster position -> coeff (scan) index.
ZIGZAG_4x4_INV = np.argsort(ZIGZAG_4x4).astype(np.int32)

# 2x2 chroma DC scan is raster order (0,1,2,3).

# luma4x4BlkIdx -> (x, y) pixel offset inside the macroblock (spec 6.4.3:
# inverse 4x4 luma block scanning process: 8x8 quadrants in raster order,
# 4x4 blocks in raster order within each quadrant).
LUMA_4x4_BLK_XY = np.array(
    [(8 * ((i >> 2) & 1) + 4 * (i & 1),
      8 * (i >> 3) + 4 * ((i >> 1) & 1)) for i in range(16)],
    dtype=np.int32)
# raster 4x4 block position (bx, by in units of 4) -> luma4x4BlkIdx
LUMA_4x4_BLK_IDX = np.zeros((4, 4), dtype=np.int32)
for _i, (_x, _y) in enumerate(LUMA_4x4_BLK_XY):
    LUMA_4x4_BLK_IDX[_y // 4, _x // 4] = _i

# ---------------------------------------------------------------------------
# Quantization (spec 8.5.9 / JVT reference design)
# ---------------------------------------------------------------------------

# Dequant scale V (spec: LevelScale4x4 normAdjust), rows = QP % 6.
_V_COLS = np.array([[10, 16, 13],
                    [11, 18, 14],
                    [13, 20, 16],
                    [14, 23, 18],
                    [16, 25, 20],
                    [18, 29, 23]], dtype=np.int32)
# Forward quant multipliers MF (JM design), rows = QP % 6.
_MF_COLS = np.array([[13107, 5243, 8066],
                     [11916, 4660, 7490],
                     [10082, 4194, 6554],
                     [9362, 3647, 5825],
                     [8192, 3355, 5243],
                     [7282, 2893, 4559]], dtype=np.int32)

# Position class within the 4x4 block: 0 for (even,even), 1 for (odd,odd),
# 2 otherwise.
_POS_CLASS = np.zeros((4, 4), dtype=np.int32)
for _y in range(4):
    for _x in range(4):
        if _y % 2 == 0 and _x % 2 == 0:
            _POS_CLASS[_y, _x] = 0
        elif _y % 2 == 1 and _x % 2 == 1:
            _POS_CLASS[_y, _x] = 1
        else:
            _POS_CLASS[_y, _x] = 2

# QUANT_V[m, y, x] and QUANT_MF[m, y, x] for m = QP % 6  (shape (6, 4, 4)).
QUANT_V = _V_COLS[:, _POS_CLASS]
QUANT_MF = _MF_COLS[:, _POS_CLASS]

# qbits = 15 + QP // 6 (for the forward path); QUANT_QBITS[qp].
QUANT_QBITS = np.array([15 + qp // 6 for qp in range(52)], dtype=np.int32)
# Forward-quant rounding offsets f = (1<<qbits)/3 (intra) or /6 (inter).
QUANT_F = np.array(
    [[(1 << (15 + qp // 6)) // 3 for qp in range(52)],    # intra
     [(1 << (15 + qp // 6)) // 6 for qp in range(52)]],   # inter
    dtype=np.int32)

# Chroma QP mapping (spec Table 8-15): QPc = QP_SCALE_CHROMA[clip(qPI, 0, 51)].
QP_SCALE_CHROMA = np.array(
    list(range(30)) +
    [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37, 38, 38,
     38, 39, 39, 39, 39], dtype=np.int32)

# ---------------------------------------------------------------------------
# Deblocking filter thresholds (spec Tables 8-16 / 8-17)
# ---------------------------------------------------------------------------

DEBLOCK_ALPHA = np.array(
    [0] * 16 +
    [4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25, 28, 32, 36, 40,
     45, 50, 56, 63, 71, 80, 90, 101, 113, 127, 144, 162, 182, 203, 226,
     255, 255], dtype=np.int32)

DEBLOCK_BETA = np.array(
    [0] * 16 +
    [2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11,
     12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18], dtype=np.int32)

# tc0 for bS = 1..3, rows = indexA 0..51 (spec Table 8-17).
DEBLOCK_TC0 = np.array(
    [[0, 0, 0]] * 16 +
    [[0, 0, 0], [0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 1, 1],
     [0, 1, 1], [1, 1, 1], [1, 1, 1], [1, 1, 1], [1, 1, 1], [1, 1, 2],
     [1, 1, 2], [1, 1, 2], [1, 1, 2], [1, 2, 3], [1, 2, 3], [2, 2, 3],
     [2, 2, 4], [2, 3, 4], [2, 3, 4], [3, 3, 5], [3, 4, 6], [3, 4, 6],
     [4, 5, 7], [4, 5, 8], [4, 6, 9], [5, 7, 10], [6, 8, 11], [6, 8, 13],
     [7, 10, 14], [8, 11, 16], [9, 12, 18], [10, 13, 20], [11, 15, 23],
     [13, 17, 25]], dtype=np.int32)

# ---------------------------------------------------------------------------
# Macroblock type tables (spec Tables 7-11, 7-13, 7-17, 7-18)
# ---------------------------------------------------------------------------

# I-slice mb_type: 0 = I_4x4 (I_NxN), 1..24 = I_16x16_<predmode>_<cbp_chroma>
# _<cbp_luma>, 25 = I_PCM.  For I_16x16 with m = mb_type - 1:
#   Intra16x16PredMode = m % 4
#   CodedBlockPatternChroma = (m // 4) % 3
#   CodedBlockPatternLuma   = 15 if m >= 12 else 0
MB_TYPE_I_NXN = 0
MB_TYPE_I_PCM = 25

# P-slice mb_type 0..4 (Table 7-13): partition shapes.
# (NumMbPart, MbPartWidth, MbPartHeight)
P_MB_PART = np.array([(1, 16, 16),   # P_L0_16x16
                      (2, 16, 8),    # P_L0_L0_16x8
                      (2, 8, 16),    # P_L0_L0_8x16
                      (4, 8, 8),     # P_8x8
                      (4, 8, 8)],    # P_8x8ref0
                     dtype=np.int32)

# P sub_mb_type 0..3 (Table 7-17): (NumSubMbPart, SubMbPartWidth, SubMbPartHeight)
P_SUB_MB_PART = np.array([(1, 8, 8),
                          (2, 8, 4),
                          (2, 4, 8),
                          (4, 4, 4)], dtype=np.int32)

# Mapping of coded_block_pattern <-> codeNum for Exp-Golomb "me(v)"
# (spec Table 9-4, Intra_4x4 / Inter columns) for ChromaArrayType = 1.
CBP_ME_INTRA = np.array(
    [47, 31, 15, 0, 23, 27, 29, 30, 7, 11, 13, 14, 39, 43, 45, 46, 16, 3, 5,
     10, 12, 19, 21, 26, 28, 35, 37, 42, 44, 1, 2, 4, 8, 17, 18, 20, 24, 6,
     9, 22, 25, 32, 33, 34, 36, 40, 38, 41], dtype=np.int32)
CBP_ME_INTER = np.array(
    [0, 16, 1, 2, 4, 8, 32, 3, 5, 10, 12, 15, 47, 7, 11, 13, 14, 6, 9, 31,
     35, 37, 42, 44, 33, 34, 36, 40, 39, 43, 45, 46, 17, 18, 20, 24, 19, 21,
     26, 28, 23, 27, 29, 30, 22, 25, 38, 41], dtype=np.int32)
# Inverse maps: cbp value (0..47) -> codeNum.
CBP_ME_INTRA_INV = np.argsort(CBP_ME_INTRA).astype(np.int32)
CBP_ME_INTER_INV = np.argsort(CBP_ME_INTER).astype(np.int32)

# ---------------------------------------------------------------------------
# Prediction mode enums (spec 8.3)
# ---------------------------------------------------------------------------

# Intra 4x4 prediction modes.
I4X4_VERT, I4X4_HORIZ, I4X4_DC, I4X4_DDL, I4X4_DDR, I4X4_VR, I4X4_HD, \
    I4X4_VL, I4X4_HU = range(9)

# Intra 16x16 prediction modes.
I16X16_VERT, I16X16_HORIZ, I16X16_DC, I16X16_PLANE = range(4)

# Intra chroma prediction modes.
ICHROMA_DC, ICHROMA_HORIZ, ICHROMA_VERT, ICHROMA_PLANE = range(4)

# 6-tap half-pel interpolation filter (spec 8.4.2.2.1).
TAP6 = np.array([1, -5, 20, 20, -5, 1], dtype=np.int32)
