"""Batched sub-pel motion compensation of 4x4 blocks (torch).

Port of ``luma_mc_blocks``, ``chroma_mc_blocks`` and the host helper
``pad_plane`` of ``hartallo_tpu/ops/interpol.py``: every 4x4 luma block
gathers its 9x9 integer-pel window from the padded reference plane, the
half-pel samples (b, h, j and their shifted variants) are integer 6-tap
sums, and the 16 fractional cases are assembled and one is picked per
block.  Chroma is the eighth-pel bilinear of 2x2 blocks.  Reference
planes are edge-replicate padded by ``PAD``; block bases are clamped so
every window stays inside the pad.  All math is int32.
"""
from __future__ import annotations

import numpy as np
import torch

PAD = 32
_TAPS = (1, -5, 20, 20, -5, 1)


def _conv6_last(x: torch.Tensor, out: int) -> torch.Tensor:
    """6-tap filter along the last dim: x (..., L) -> (..., out), window
    [k, k+6)."""
    return sum(t * x[..., k:k + out] for k, t in enumerate(_TAPS))


def _flat_ref(ref_pad, ref_sel, like):
    """(Hp, Wp) or (R, Hp, Wp) plane(s) -> (rows, Wp) view, per-block row
    base, Hp, Wp."""
    if ref_pad.dim() == 3:
        nref, Hp, Wp = ref_pad.shape
        return (ref_pad.reshape(nref * Hp, Wp),
                torch.clamp(ref_sel, 0, nref - 1) * Hp, Hp, Wp)
    Hp, Wp = ref_pad.shape
    return ref_pad, torch.zeros_like(like), Hp, Wp


def luma_mc_blocks(ref_pad, bx, by, mvx, mvy, ref_sel=None):
    """Quarter-pel MC for N 4x4 luma blocks.  ref_pad (Hp, Wp) int32
    padded by PAD, or (R, Hp, Wp) with ``ref_sel`` (N,) picking a plane
    per block; bx, by (N,) block origins in frame coordinates; mvx, mvy
    (N,) quarter-pel.  Returns (N, 4, 4) int32."""
    dev = ref_pad.device
    ref_flat, row_base, Hp, Wp = _flat_ref(ref_pad, ref_sel, bx)
    H, W = Hp - 2 * PAD, Wp - 2 * PAD
    fx = (mvx & 3).to(torch.int32)
    fy = (mvy & 3).to(torch.int32)
    xi = torch.clamp(bx + (mvx >> 2), -(PAD - 2), W + PAD - 7)
    yi = torch.clamp(by + (mvy >> 2), -(PAD - 2), H + PAD - 7)
    r9 = torch.arange(9, device=dev)
    rows = (yi[:, None] + PAD - 2 + row_base[:, None]) + r9[None, :]
    cols = (xi[:, None] + PAD - 2) + r9[None, :]
    R = ref_flat[rows[:, :, None].long(), cols[:, None, :].long()] \
        .to(torch.int32)                                      # (N, 9, 9)

    H1 = _conv6_last(R, 4)                 # (N, 9, 4) horiz sums, cols 2..5
    V1 = _conv6_last(R.transpose(1, 2), 4)     # (N, 9, 4): [n, col, row]
    b = torch.clamp((H1[:, 2:6, :] + 16) >> 5, 0, 255)
    s = torch.clamp((H1[:, 3:7, :] + 16) >> 5, 0, 255)       # b shifted +y
    h = torch.clamp((V1[:, 2:6, :] + 16) >> 5, 0, 255).transpose(1, 2)
    m = torch.clamp((V1[:, 3:7, :] + 16) >> 5, 0, 255).transpose(1, 2)
    vfull = sum(t * R[:, k:k + 4, :] for k, t in enumerate(_TAPS))
    j = torch.clamp((_conv6_last(vfull, 4) + 512) >> 10, 0, 255)

    G = R[:, 2:6, 2:6]
    Gx = R[:, 2:6, 3:7]
    Gy = R[:, 3:7, 2:6]
    bank = torch.stack([
        G, (G + b + 1) >> 1, b, (b + Gx + 1) >> 1,
        (G + h + 1) >> 1, (b + h + 1) >> 1, (b + j + 1) >> 1,
        (b + m + 1) >> 1,
        h, (h + j + 1) >> 1, j, (j + m + 1) >> 1,
        (h + Gy + 1) >> 1, (h + s + 1) >> 1, (j + s + 1) >> 1,
        (m + s + 1) >> 1], dim=1)                           # (N, 16, 4, 4)
    case = (fy * 4 + fx).long()
    return bank[torch.arange(bank.shape[0], device=dev), case]


def chroma_mc_blocks(ref_pad, bx, by, mvx, mvy, ref_sel=None):
    """Eighth-pel bilinear MC for N 2x2 chroma blocks; returns (N, 2, 2)
    int32 (arguments as ``luma_mc_blocks``, chroma coordinates)."""
    dev = ref_pad.device
    ref_flat, row_base, Hp, Wp = _flat_ref(ref_pad, ref_sel, bx)
    H, W = Hp - 2 * PAD, Wp - 2 * PAD
    dx = (mvx & 7).to(torch.int32)[:, None, None]
    dy = (mvy & 7).to(torch.int32)[:, None, None]
    xi = torch.clamp(bx + (mvx >> 3), -(PAD - 1), W + PAD - 4)
    yi = torch.clamp(by + (mvy >> 3), -(PAD - 1), H + PAD - 4)
    r3 = torch.arange(3, device=dev)
    rows = (yi[:, None] + PAD + row_base[:, None]) + r3[None, :]
    cols = (xi[:, None] + PAD) + r3[None, :]
    R = ref_flat[rows[:, :, None].long(), cols[:, None, :].long()] \
        .to(torch.int32)                                      # (N, 3, 3)
    A, B = R[:, 0:2, 0:2], R[:, 0:2, 1:3]
    C, D = R[:, 1:3, 0:2], R[:, 1:3, 1:3]
    return ((8 - dx) * (8 - dy) * A + dx * (8 - dy) * B +
            (8 - dx) * dy * C + dx * dy * D + 32) >> 6


def pad_plane(plane: np.ndarray) -> np.ndarray:
    """Edge-replicate pad by PAD (host helper)."""
    return np.pad(plane, PAD, mode="edge")
