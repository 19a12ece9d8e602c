"""Inverse integer transform and dequantisation on torch tensors.

Port of the decode half of ``hartallo_tpu/ops/transform.py`` (8.5.10 -
8.5.12): each function takes blocks with any leading batch dimensions and
a matching per-block QP tensor, and works in int32 on the blocks' device.
The forward transform and quantiser belong to the encoder and are not
ported yet.
"""
from __future__ import annotations

import torch

from hartallo_tpu.core import tables as T


def _quant_v(device) -> torch.Tensor:
    return torch.as_tensor(T.QUANT_V, dtype=torch.int32, device=device)


def dequant_4x4(c: torch.Tensor, qp: torch.Tensor,
                dc_bypass: bool = False) -> torch.Tensor:
    """8.5.12.1 flat-list dequant; c (..., 4, 4), qp (...,)."""
    c = c.to(torch.int32)
    qp = torch.as_tensor(qp, dtype=torch.int32, device=c.device)
    ls = 16 * _quant_v(c.device)[qp % 6]
    qdiv = (qp // 6)[..., None, None]
    hi = (c * ls) << torch.clamp(qdiv - 4, min=0)
    lo = (c * ls + (1 << torch.clamp(3 - qdiv, min=0))) >> \
        torch.clamp(4 - qdiv, min=0)
    d = torch.where(qp[..., None, None] >= 24, hi, lo)
    if dc_bypass:
        d[..., 0, 0] = c[..., 0, 0]
    return d


def inverse_transform_4x4(d: torch.Tensor) -> torch.Tensor:
    """8.5.12.2 inverse core transform, batched over (..., 4, 4)."""
    d = d.to(torch.int32)
    d0, d1, d2, d3 = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
    e0, e1 = d0 + d2, d0 - d2
    e2, e3 = (d1 >> 1) - d3, d1 + (d3 >> 1)
    f = torch.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], dim=-1)
    f0, f1, f2, f3 = f[..., 0, :], f[..., 1, :], f[..., 2, :], f[..., 3, :]
    g0, g1 = f0 + f2, f0 - f2
    g2, g3 = (f1 >> 1) - f3, f1 + (f3 >> 1)
    h = torch.stack([g0 + g3, g1 + g2, g1 - g2, g0 - g3], dim=-2)
    return (h + 32) >> 6


def _hadamard_4x4(x: torch.Tensor) -> torch.Tensor:
    x0, x1, x2, x3 = x[..., 0, :], x[..., 1, :], x[..., 2, :], x[..., 3, :]
    a0, a1 = x0 + x1, x0 - x1
    b0, b1 = x2 + x3, x2 - x3
    t = torch.stack([a0 + b0, a0 - b0, a1 - b1, a1 + b1], dim=-2)
    t0, t1, t2, t3 = t[..., 0], t[..., 1], t[..., 2], t[..., 3]
    c0, c1 = t0 + t1, t0 - t1
    d0, d1 = t2 + t3, t2 - t3
    return torch.stack([c0 + d0, c0 - d0, c1 - d1, c1 + d1], dim=-1)


def _hadamard_2x2(c: torch.Tensor) -> torch.Tensor:
    t00 = c[..., 0, 0] + c[..., 1, 0]
    t01 = c[..., 0, 1] + c[..., 1, 1]
    t10 = c[..., 0, 0] - c[..., 1, 0]
    t11 = c[..., 0, 1] - c[..., 1, 1]
    return torch.stack([torch.stack([t00 + t01, t00 - t01], dim=-1),
                        torch.stack([t10 + t11, t10 - t11], dim=-1)], dim=-2)


def luma_dc_descale_intra16(c: torch.Tensor,
                            qp: torch.Tensor) -> torch.Tensor:
    """8.5.10: c (..., 4, 4) Intra16x16 DC levels, qp (...,)."""
    f = _hadamard_4x4(c.to(torch.int32))
    qp = torch.as_tensor(qp, dtype=torch.int32, device=c.device)
    scale = (16 * _quant_v(c.device)[qp % 6, 0, 0])[..., None, None]
    qdiv = (qp // 6)[..., None, None]
    hi = (f * scale) << torch.clamp(qdiv - 6, min=0)
    lo = (f * scale + (1 << torch.clamp(5 - qdiv, min=0))) >> \
        torch.clamp(6 - qdiv, min=0)
    return torch.where(qp[..., None, None] >= 36, hi, lo)


def chroma_dc_descale(c: torch.Tensor, qp: torch.Tensor) -> torch.Tensor:
    """8.5.11 (4:2:0): c (..., 2, 2), qp (...,)."""
    f = _hadamard_2x2(c.to(torch.int32))
    qp = torch.as_tensor(qp, dtype=torch.int32, device=c.device)
    scale = (16 * _quant_v(c.device)[qp % 6, 0, 0])[..., None, None]
    return ((f * scale) << (qp // 6)[..., None, None]) >> 5
