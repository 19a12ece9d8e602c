"""CAVLC residual block coding (spec 9.2), host-serial reference path.

Decode parity: ``hl_codec_264_residual.c:280-586`` (_read_block_cavlc);
encode parity: ``:587-902`` (write_block_cavlc).  The level prefix/suffix
state machine follows spec 9.2.2.1/9.2.2.2 exactly (integer-exact).

Blocks are represented as ``levels[16]`` in *scan order* (zig-zag for 4x4,
raster for 2x2 chroma DC); callers apply the zig-zag permutation when
scattering into coefficient tensors.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from portbench.reference.h264.bitio import BitReader, BitWriter
from portbench.reference.h264.entropy import cavlc_tables as CT


# ---------------------------------------------------------------------------
# coeff_token
# ---------------------------------------------------------------------------

# What the reference decoder does with bit patterns outside the spec VLC:
# its HL_NO_CLZ piecewise tables are total functions whose unassigned
# patterns land on explicit "error" entries {TO=0, TC=0, consume N bits}
# (``hl_codec_264_cavlc.c:176-210``: TotCofNTrail1[0..1]={0,0,16},
# TotCofNTrail2[0..1]={0,0,14}, TotCofNTrail3[0]={0,0,10}).  Garbage decode
# must follow the same path to stay bit-exact with the reference on
# streams its own encoder mis-writes.
_CT_ERROR_SKIP = (16, 14, 10)


def read_coeff_token(r: BitReader, nC: int) -> Tuple[int, int]:
    """Returns (TotalCoeff, TrailingOnes)."""
    if nC >= 8:
        code = r.u(6)
        if code == 3:
            return 0, 0
        return (code >> 2) + 1, code & 3
    if nC == -1:
        lut_sym, lut_len, maxlen = CT.COEFF_TOKEN_CDC_LUT
        peek = r.peek(maxlen)
        sym = int(lut_sym[peek])
        if sym < 0:
            raise ValueError("invalid chroma-DC coeff_token")
        r.skip(int(lut_len[peek]))
        return sym >> 2, sym & 3
    ctx = 0 if nC < 2 else (1 if nC < 4 else 2)
    lut_sym, lut_len, maxlen = CT.COEFF_TOKEN_LUT[ctx]
    peek = r.peek(maxlen)
    sym = int(lut_sym[peek])
    if sym < 0:
        r.skip(_CT_ERROR_SKIP[ctx])   # reference error entry: TC=0, TO=0
        return 0, 0
    r.skip(int(lut_len[peek]))
    return sym >> 2, sym & 3


def write_coeff_token(w: BitWriter, total_coeff: int, trailing_ones: int,
                      nC: int) -> None:
    if nC >= 8:
        code = 3 if total_coeff == 0 else \
            ((total_coeff - 1) << 2) | trailing_ones
        w.u(code, 6)
    elif nC == -1:
        w.u(int(CT.COEFF_TOKEN_CDC_VAL[trailing_ones, total_coeff]),
            int(CT.COEFF_TOKEN_CDC_LEN[trailing_ones, total_coeff]))
    else:
        ctx = 0 if nC < 2 else (1 if nC < 4 else 2)
        w.u(int(CT.COEFF_TOKEN_VAL[ctx, trailing_ones, total_coeff]),
            int(CT.COEFF_TOKEN_LEN[ctx, trailing_ones, total_coeff]))


# ---------------------------------------------------------------------------
# Level prefix/suffix (spec 9.2.2)
# ---------------------------------------------------------------------------

def _read_level_prefix(r: BitReader) -> int:
    """Reference semantics (``hl_codec_264_cavlc.c:407-420``): the prefix
    is clz16 of a 16-bit window, so it is capped at 16 — an all-zero
    window consumes 17 bits and yields prefix 16 instead of scanning on.
    (This also means neither side of the codec may emit prefix > 16.)"""
    w = r.peek(16)
    zeros = 16 if w == 0 else 16 - w.bit_length()
    r.skip(zeros + 1)
    return zeros


def read_residual_block(r: BitReader, nC: int,
                        max_num_coeff: int = 16) -> Tuple[np.ndarray, int]:
    """Parse one CAVLC block; returns (levels[max_num_coeff] scan order,
    TotalCoeff)."""
    total_coeff, trailing_ones = read_coeff_token(r, nC)
    levels = np.zeros(max_num_coeff, dtype=np.int32)
    if total_coeff == 0:
        return levels, 0

    level_val = np.zeros(total_coeff, dtype=np.int64)
    suffix_length = 1 if total_coeff > 10 and trailing_ones < 3 else 0
    for i in range(total_coeff):
        if i < trailing_ones:
            level_val[i] = 1 - 2 * r.u1()
            continue
        level_prefix = _read_level_prefix(r)
        level_suffix_size = suffix_length
        if level_prefix == 14 and suffix_length == 0:
            level_suffix_size = 4
        elif level_prefix >= 15:
            level_suffix_size = level_prefix - 3
        level_suffix = r.u(level_suffix_size) if level_suffix_size else 0
        level_code = (min(15, level_prefix) << suffix_length) + level_suffix
        if level_prefix >= 15 and suffix_length == 0:
            level_code += 15
        if level_prefix >= 16:
            level_code += (1 << (level_prefix - 3)) - 4096
        if i == trailing_ones and trailing_ones < 3:
            level_code += 2
        if level_code % 2 == 0:
            level_val[i] = (level_code + 2) >> 1
        else:
            level_val[i] = -((level_code + 1) >> 1)
        if suffix_length == 0:
            suffix_length = 1
        if abs(int(level_val[i])) > (3 << (suffix_length - 1)) and \
                suffix_length < 6:
            suffix_length += 1

    if total_coeff < max_num_coeff:
        if nC == -1:
            lut_sym, lut_len, maxlen = CT.TOTAL_ZEROS_CDC_LUT[total_coeff - 1]
        else:
            lut_sym, lut_len, maxlen = CT.TOTAL_ZEROS_LUT[total_coeff - 1]
        peek = r.peek(maxlen)
        total_zeros = int(lut_sym[peek])
        if total_zeros < 0:
            raise ValueError("invalid total_zeros")
        r.skip(int(lut_len[peek]))
    else:
        total_zeros = 0

    # runs (spec 9.2.3): coeffs are delivered highest-frequency first.
    zeros_left = total_zeros
    runs = np.zeros(total_coeff, dtype=np.int32)
    for i in range(total_coeff - 1):
        if zeros_left > 0:
            if zeros_left >= 7:
                # reference algorithm (hl_codec_264_cavlc.c:609-651):
                # 3-bit code, run = 7 - code; code 0 escapes to a
                # clz16-bounded unary tail (run up to 7 + 16).
                t3 = r.u(3)
                if t3:
                    run = 7 - t3
                else:
                    p9 = r.peek(9)
                    ind = 16 if p9 == 0 else 9 - p9.bit_length()
                    run = 7 + ind
                    r.skip(ind + 1)
            else:
                lut_sym, lut_len, maxlen = \
                    CT.RUN_BEFORE_LUT[zeros_left - 1]
                peek = r.peek(maxlen)
                run = int(lut_sym[peek])
                if run < 0:
                    raise ValueError("invalid run_before")
                r.skip(int(lut_len[peek]))
        else:
            run = 0
        runs[i] = run
        zeros_left -= run
    runs[total_coeff - 1] = zeros_left

    pos = total_zeros + total_coeff - 1
    for i in range(total_coeff):
        # garbage runs can push pos out of range; the reference scatters
        # those into scratch slack (residual.c:573-578) — drop them here
        if 0 <= pos < max_num_coeff:
            levels[pos] = level_val[i]
        pos -= runs[i] + 1
    return levels, total_coeff


def _write_level_code(w: BitWriter, level_code: int,
                      suffix_length: int) -> None:
    """Emit one coeff_level (inverse of spec 9.2.2.1/9.2.2.2), including the
    level_prefix >= 16 extended escapes."""
    if suffix_length == 0:
        if level_code < 14:
            w.u(1, level_code + 1)                # level_code zeros + 1
            return
        if level_code < 30:
            w.u(1, 15)                            # level_prefix = 14
            w.u(level_code - 14, 4)
            return
        rem = level_code - 30
    else:
        if level_code < (15 << suffix_length):
            prefix = level_code >> suffix_length
            w.u(1, prefix + 1)
            w.u(level_code & ((1 << suffix_length) - 1), suffix_length)
            return
        rem = level_code - (15 << suffix_length)
    if rem < 4096:
        w.u(1, 16)                                # level_prefix = 15
        w.u(rem, 12)
        return
    p = 16                                        # level_prefix >= 16
    while rem >= (1 << (p - 2)) - 4096:
        p += 1
    w.u(1, p + 1)
    w.u(rem - ((1 << (p - 3)) - 4096), p - 3)


def write_residual_block(w: BitWriter, levels: np.ndarray, nC: int,
                         max_num_coeff: int = 16) -> int:
    """Encode one block of scan-order levels; returns TotalCoeff."""
    nz = np.nonzero(levels[:max_num_coeff])[0]
    total_coeff = int(nz.size)
    if total_coeff == 0:
        write_coeff_token(w, 0, 0, nC)
        return 0
    hi = int(nz[-1])
    total_zeros = hi + 1 - total_coeff
    # trailing ones: up to 3 consecutive +-1 at the high-frequency end
    trailing_ones = 0
    vals = [int(levels[i]) for i in nz]
    for v in reversed(vals):
        if abs(v) == 1 and trailing_ones < 3:
            trailing_ones += 1
        else:
            break
    write_coeff_token(w, total_coeff, trailing_ones, nC)

    # levels high-frequency first
    suffix_length = 1 if total_coeff > 10 and trailing_ones < 3 else 0
    order = list(reversed(vals))
    for i, v in enumerate(order):
        if i < trailing_ones:
            w.u1(0 if v > 0 else 1)
            continue
        level_code = 2 * v - 2 if v > 0 else -2 * v - 1
        if i == trailing_ones and trailing_ones < 3:
            level_code -= 2
        _write_level_code(w, level_code, suffix_length)
        if suffix_length == 0:
            suffix_length = 1
        if abs(v) > (3 << (suffix_length - 1)) and suffix_length < 6:
            suffix_length += 1

    if total_coeff < max_num_coeff:
        if nC == -1:
            w.u(int(CT.TOTAL_ZEROS_CDC_VAL[total_coeff - 1, total_zeros]),
                int(CT.TOTAL_ZEROS_CDC_LEN[total_coeff - 1, total_zeros]))
        else:
            w.u(int(CT.TOTAL_ZEROS_VAL[total_coeff - 1, total_zeros]),
                int(CT.TOTAL_ZEROS_LEN[total_coeff - 1, total_zeros]))

    zeros_left = total_zeros
    positions = list(reversed(nz.tolist()))
    for i in range(total_coeff - 1):
        if zeros_left <= 0:
            break
        run = positions[i] - positions[i + 1] - 1
        row = min(zeros_left, 7) - 1
        w.u(int(CT.RUN_BEFORE_VAL[row, run]),
            int(CT.RUN_BEFORE_LEN[row, run]))
        zeros_left -= run
    return total_coeff
