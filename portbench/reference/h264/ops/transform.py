"""Integer transforms and (de)quantisation on torch tensors.

Port of ``hartallo_tpu/ops/transform.py``: the decode half (8.5.10 -
8.5.12: dequant, inverse core transform, DC descales) and the encoder's
forward core transform, quantiser and DC Hadamard quantisers.  Each
function takes blocks with any leading batch dimensions and a matching
per-block QP tensor, and works in int32 on the blocks' device.
"""
from __future__ import annotations

from functools import lru_cache

import torch

from portbench.reference.h264.core import tables as T


@lru_cache(maxsize=None)
def _qtab(name: str, device) -> torch.Tensor:
    """A quantiser table of ``core.tables`` as int32 on ``device``, made
    once per device (a host-to-device copy inside the encoder's per-block
    loops would stall the stream each time).  Shared: never written."""
    return torch.as_tensor(getattr(T, name), dtype=torch.int32,
                           device=device)


def _quant_v(device) -> torch.Tensor:
    return _qtab("QUANT_V", device)


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


# ---------------------------------------------------------------------------
# Forward half (encoder)
# ---------------------------------------------------------------------------

def _deadzone(qp: torch.Tensor, intra) -> torch.Tensor:
    """Quantiser rounding offset f per block: intra or inter table."""
    f = _qtab("QUANT_F", qp.device)
    intra = torch.as_tensor(intra, dtype=torch.bool,
                            device=qp.device).expand(qp.shape)
    return torch.where(intra, f[0][qp], f[1][qp])


def forward_dct_4x4(x: torch.Tensor) -> torch.Tensor:
    """Forward integer core transform W = C x C^T, batched (butterflies)."""
    x = x.to(torch.int32)
    x0, x1, x2, x3 = x[..., 0, :], x[..., 1, :], x[..., 2, :], x[..., 3, :]
    s0, s3 = x0 + x3, x0 - x3
    s1, s2 = x1 + x2, x1 - x2
    t = torch.stack([s0 + s1, 2 * s3 + s2, s0 - s1, s3 - 2 * s2], dim=-2)
    t0, t1, t2, t3 = t[..., 0], t[..., 1], t[..., 2], t[..., 3]
    u0, u3 = t0 + t3, t0 - t3
    u1, u2 = t1 + t2, t1 - t2
    return torch.stack([u0 + u1, 2 * u3 + u2, u0 - u1, u3 - 2 * u2], dim=-1)


def forward_quant_4x4(w: torch.Tensor, qp, intra,
                      skip_dc: bool = False) -> torch.Tensor:
    """Z = sign(W) * ((|W| * MF + f) >> qbits); qp (...,), intra bool or
    (...,) bool."""
    w = w.to(torch.int32)
    qp = torch.as_tensor(qp, dtype=torch.int32, device=w.device)
    mf = _qtab("QUANT_MF", w.device)[qp % 6]
    qbits = _qtab("QUANT_QBITS", w.device)[qp][..., None, None]
    f = _deadzone(qp, intra)[..., None, None]
    z = ((w.abs() * mf + f) >> qbits) * torch.sign(w)
    if skip_dc:
        z[..., 0, 0] = 0
    return z


def forward_hadamard_quant_dc_luma(c: torch.Tensor, qp) -> torch.Tensor:
    """Intra16x16 luma DC: (McM)>>1 then quant with 2f deadzone, qbits+1."""
    f4 = _hadamard_4x4(c.to(torch.int32)) >> 1
    qp = torch.as_tensor(qp, dtype=torch.int32, device=c.device)
    mf = _qtab("QUANT_MF", c.device)[qp % 6, 0, 0][..., None, None]
    qbits = _qtab("QUANT_QBITS", c.device)[qp][..., None, None]
    off = (2 * _qtab("QUANT_F", c.device)[0][qp])[..., None, None]
    return ((f4.abs() * mf + off) >> (qbits + 1)) * torch.sign(f4)


def forward_hadamard_quant_dc_chroma(c: torch.Tensor, qp,
                                     intra) -> torch.Tensor:
    """Chroma 2x2 DC Hadamard + quant (2f deadzone, qbits+1), batched."""
    f = _hadamard_2x2(c.to(torch.int32))
    qp = torch.as_tensor(qp, dtype=torch.int32, device=c.device)
    mf = _qtab("QUANT_MF", c.device)[qp % 6, 0, 0][..., None, None]
    qbits = _qtab("QUANT_QBITS", c.device)[qp][..., None, None]
    off = (2 * _deadzone(qp, intra))[..., None, None]
    return ((f.abs() * mf + off) >> (qbits + 1)) * torch.sign(f)
