"""Hadamard SATD on torch tensors (reference ``hl_math.c:283``).

Port of ``satd4x4`` and ``_hadamard4`` of ``hartallo_tpu/ops/math.py``,
the distortion of the encoder's sub-pel refinement and intra-in-P
estimate.  The other members of that module have no caller and are not
ported.
"""
from __future__ import annotations

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
