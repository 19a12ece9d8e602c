"""Batched distortion / activity kernels on torch tensors (reference
``hl_math.c`` family).

Port of ``hartallo_tpu/ops/math.py``: ``satd4x4`` (Hadamard SATD,
``hl_math.c:283``), the distortion of the encoder's sub-pel refinement
and intra-in-P estimate; its scalar numpy oracle ``satd4x4_np``; and
``mae4x4``, ``mse4x4`` and ``homogeneousity8x8`` (``hl_math.c:470``, the
reference's fast-mode-preselect signal), which no codec path calls.
Integer-exact: every input is widened to int32 before any arithmetic.
"""
from __future__ import annotations

import numpy as np
import torch


def _hadamard4(d: torch.Tensor) -> torch.Tensor:
    """H @ d @ H for (..., 4, 4) int32 (H = 4x4 Hadamard, un-normalized)."""
    def stage(a, dim):
        a0, a1, a2, a3 = (a.select(dim, i) for i in range(4))
        return torch.stack([a0 + a1 + a2 + a3,
                            a0 + a1 - a2 - a3,
                            a0 - a1 - a2 + a3,
                            a0 - a1 + a2 - a3], dim=dim)
    return stage(stage(d, -2), -1)


def satd4x4(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SATD per block: sum(|H (a-b) H|) >> 1 (the /2 after the abs-sum,
    exactly as ``hl_math_satd4x4_u8_cpp``).  a, b (..., 4, 4); returns
    (...,) int32."""
    t = _hadamard4(a.to(torch.int32) - b.to(torch.int32))
    return t.abs().sum(dim=(-1, -2), dtype=torch.int32) >> 1


def satd4x4_np(a: np.ndarray, b: np.ndarray) -> int:
    """Scalar oracle."""
    H = np.array([[1, 1, 1, 1], [1, 1, -1, -1],
                  [1, -1, -1, 1], [1, -1, 1, -1]], np.int64)
    d = a.astype(np.int64) - b.astype(np.int64)
    return int(np.abs(H @ d @ H).sum()) >> 1


def mae4x4(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean absolute error per block ((sum|a-b|) >> 4,
    ``hl_math_mae4x4_u8_cpp``).  a, b (..., 4, 4); returns (...,) int32."""
    return (a.to(torch.int32) - b.to(torch.int32)).abs() \
        .sum(dim=(-1, -2), dtype=torch.int32) >> 4


def mse4x4(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean squared error per block ((sum (a-b)^2) >> 4,
    ``hl_math_mse4x4_u8_cpp``).  a, b (..., 4, 4); returns (...,) int32."""
    d = a.to(torch.int32) - b.to(torch.int32)
    return (d * d).sum(dim=(-1, -2), dtype=torch.int32) >> 4


def homogeneousity8x8(blocks: torch.Tensor) -> torch.Tensor:
    """Edge-activity metric per 8x8 block (``hl_math.c:470``): sum of
    |horizontal gradient| + |vertical gradient| over the interior.
    blocks (..., 8, 8); returns (...,) int32."""
    b = blocks.to(torch.int32)
    gh_ = (b[..., :, 1:] - b[..., :, :-1]).abs().sum(dim=(-1, -2),
                                                     dtype=torch.int32)
    gv_ = (b[..., 1:, :] - b[..., :-1, :]).abs().sum(dim=(-1, -2),
                                                     dtype=torch.int32)
    return gh_ + gv_
