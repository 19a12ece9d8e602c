"""Wide-layout decode ops on torch tensors.

Port of ``hartallo_tpu/ops/wide.py``: the half-pel planes carried with
each reference frame (b, h, j of spec 8.4.2.2.1, computed once per decoded
frame as separable 6-tap filters), quarter-pel MC as two gathers from
those planes and an average, eighth-pel chroma MC, the whole-frame
residual decode (dequant + inverse transform) and the boundary-strength
grids of 8.7.2.1.  All integer math is int32; uint8 inputs are widened
before any arithmetic.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.h264.core import tables as T
from portbench.reference.h264.core.tables import LUMA_4x4_BLK_XY

PAD = 32
_TAPS = (1, -5, 20, 20, -5, 1)


def _edge_pad(x: torch.Tensor, before: int, after: int,
              dim: int) -> torch.Tensor:
    """Replicate the edge samples of ``x`` along ``dim``."""
    n = x.shape[dim]
    idx = torch.clamp(torch.arange(-before, n + after, device=x.device),
                      0, n - 1)
    return x.index_select(dim, idx)


def pad_edge(x: torch.Tensor, n: int = PAD) -> torch.Tensor:
    """Edge-replicate pad of a 2-D plane by n on every side."""
    return _edge_pad(_edge_pad(x, n, n, 0), n, n, 1)


def _conv6(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Unrounded 6-tap along ``dim``; x (..., n+5, ...) -> (..., n, ...)."""
    n = x.shape[dim] - 5
    return sum(t * x.narrow(dim, k, n) for k, t in enumerate(_TAPS))


def halfpel_planes(pad_plane: torch.Tensor) -> torch.Tensor:
    """(Hp, Wp) edge-padded luma plane -> (4, Hp, Wp) int32 stack
    [G, b, h, j] of the integer and half-pel grids."""
    G = pad_plane.to(torch.int32)
    H1 = _conv6(_edge_pad(G, 2, 3, 1), 1)                  # unrounded horiz
    b = torch.clamp((H1 + 16) >> 5, 0, 255)
    V1 = _conv6(_edge_pad(G, 2, 3, 0), 0)                  # unrounded vert
    h = torch.clamp((V1 + 16) >> 5, 0, 255)
    J1 = _conv6(_edge_pad(H1, 2, 3, 0), 0)                 # 6-tap over H1
    j = torch.clamp((J1 + 512) >> 10, 0, 255)
    return torch.stack([G, b, h, j])


# quarter-pel case tables: case = 4*fy + fx -> (p0, dx0, dy0, p1, dx1, dy1),
# averaged as (A + B + 1) >> 1.  Planes: 0=G 1=b 2=h 3=j
_QPT = np.asarray([
    (0, 0, 0, 0, 0, 0), (0, 0, 0, 1, 0, 0), (1, 0, 0, 1, 0, 0),
    (1, 0, 0, 0, 1, 0), (0, 0, 0, 2, 0, 0), (1, 0, 0, 2, 0, 0),
    (1, 0, 0, 3, 0, 0), (1, 0, 0, 2, 1, 0), (2, 0, 0, 2, 0, 0),
    (2, 0, 0, 3, 0, 0), (3, 0, 0, 3, 0, 0), (3, 0, 0, 2, 1, 0),
    (2, 0, 0, 0, 0, 1), (2, 0, 0, 1, 0, 1), (3, 0, 0, 1, 0, 1),
    (2, 1, 0, 1, 0, 1)], np.int32)                       # (16, 6)


def mc_grids(gw: int, gh: int, device):
    """Block origins, block index ordered (my, mx, by, bx): luma x, luma y,
    chroma x, chroma y, each (gh*gw*16,) int32 on ``device``."""
    myg, mxg, byg, bxg = np.meshgrid(np.arange(gh), np.arange(gw),
                                     np.arange(4), np.arange(4),
                                     indexing="ij")
    n = gh * gw * 16
    return tuple(torch.as_tensor(a.reshape(n).astype(np.int32),
                                 device=device)
                 for a in (mxg * 16 + bxg * 4, myg * 16 + byg * 4,
                           mxg * 8 + bxg * 2, myg * 8 + byg * 2))


def _to_grid(v: torch.Tensor, gw: int, gh: int) -> torch.Tensor:
    """(N,) block-ordered (my, mx, by, bx) -> (4gh, 4gw) block grid."""
    return v.reshape(gh, gw, 4, 4).permute(0, 2, 1, 3) \
        .reshape(4 * gh, 4 * gw)


def _expand(g: torch.Tensor, s: int) -> torch.Tensor:
    return g.repeat_interleave(s, 0).repeat_interleave(s, 1)


def _weigh(pred, w, o, lwd):
    """8.4.2.3.2 explicit uni-pred weighting (identity at (1, 0, 0))."""
    return torch.clamp(((pred * w + ((1 << lwd) >> 1)) >> lwd) + o, 0, 255)


def mc_luma_plane(stack, slot, bx, by, mvx, mvy, wp3, gw: int, gh: int):
    """Quarter-pel MC producing the (H, W) int32 luma prediction plane.

    stack: (S, 4, Hp, Wp) ring of [G, b, h, j] per slot (may be
    over-allocated; its dims are used as strides).  slot/bx/by/mvx/mvy:
    (N,) per 4x4 block, N ordered (my, mx, by, bx).  wp3: (N, 3)
    weighted-prediction [w, o, logWD] per block."""
    S, _, Hp, Wp = stack.shape
    H, W = gh * 16, gw * 16
    dev = stack.device
    flat = stack.reshape(-1)
    xi = torch.clamp(bx + (mvx >> 2), -(PAD - 2), W + PAD - 7)
    yi = torch.clamp(by + (mvy >> 2), -(PAD - 2), H + PAD - 7)
    cs = torch.as_tensor(_QPT, device=dev)[4 * (mvy & 3) + (mvx & 3)]
    yy = (torch.arange(H, device=dev) % 4)[:, None] * Wp
    xx = (torch.arange(W, device=dev) % 4)[None, :]

    def tap(p, dx, dy):
        base = ((slot.long() * 4 + p) * Hp + (yi + dy + PAD)) * Wp + \
            (xi + dx + PAD)
        px = _expand(_to_grid(base, gw, gh), 4)
        return torch.take(flat, px + yy + xx).to(torch.int32)

    A = tap(cs[:, 0], cs[:, 1], cs[:, 2])
    B = tap(cs[:, 3], cs[:, 4], cs[:, 5])
    pred = (A + B + 1) >> 1
    w, o, lwd = (_expand(_to_grid(wp3[:, i], gw, gh), 4) for i in range(3))
    return _weigh(pred, w, o, lwd)


def mc_chroma_plane(ring, slot, bx, by, mvx, mvy, wp3, gw: int, gh: int):
    """Eighth-pel bilinear MC producing the (H/2, W/2) int32 chroma plane.
    Inputs as mc_luma_plane (chroma block origins); ring (S, Hp, Wp)."""
    S, Hp, Wp = ring.shape
    H, W = gh * 8, gw * 8
    dev = ring.device
    flat = ring.reshape(-1)
    xi = torch.clamp(bx + (mvx >> 3), -(PAD - 1), W + PAD - 4)
    yi = torch.clamp(by + (mvy >> 3), -(PAD - 1), H + PAD - 4)
    base = (slot.long() * Hp + yi + PAD) * Wp + (xi + PAD)
    px = _expand(_to_grid(base, gw, gh), 2) + \
        (torch.arange(8 * gh, device=dev) % 2)[:, None] * Wp + \
        (torch.arange(8 * gw, device=dev) % 2)[None, :]
    A = torch.take(flat, px).to(torch.int32)
    B = torch.take(flat, px + 1).to(torch.int32)
    C = torch.take(flat, px + Wp).to(torch.int32)
    D = torch.take(flat, px + Wp + 1).to(torch.int32)
    dx = _expand(_to_grid(mvx & 7, gw, gh), 2)
    dy = _expand(_to_grid(mvy & 7, gw, gh), 2)
    pred = ((8 - dx) * (8 - dy) * A + dx * (8 - dy) * B +
            (8 - dx) * dy * C + dx * dy * D + 32) >> 6
    w, o, lwd = (_expand(_to_grid(wp3[:, i], gw, gh), 2) for i in range(3))
    return _weigh(pred, w, o, lwd)


# ---------------------------------------------------------------------------
# Wide residual decode (dequant + IDCT + plane assembly)
# ---------------------------------------------------------------------------

# spec blkIdx -> raster 4x4-block position inside the MB
_BLK_RASTER = ((LUMA_4x4_BLK_XY[:, 1] // 4) * 4 +
               (LUMA_4x4_BLK_XY[:, 0] // 4)).astype(np.int64)
_RASTER_TO_BLK = np.argsort(_BLK_RASTER)


def _ict_stage(d: torch.Tensor, dim: int) -> torch.Tensor:
    d0, d1, d2, d3 = (d.select(dim, i) for i in range(4))
    e0, e1 = d0 + d2, d0 - d2
    e2, e3 = (d1 >> 1) - d3, d1 + (d3 >> 1)
    return torch.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], dim=dim)


def idct_wide(X: torch.Tensor) -> torch.Tensor:
    """8.5.12.2 inverse core transform; X (..., 4, 4, N) [row, col, N]."""
    return (_ict_stage(_ict_stage(X, -2), -3) + 32) >> 6


def _had_stage(d: torch.Tensor, dim: int) -> torch.Tensor:
    d0, d1, d2, d3 = (d.select(dim, i) for i in range(4))
    a0, a1 = d0 + d1, d0 - d1
    b0, b1 = d2 + d3, d2 - d3
    return torch.stack([a0 + b0, a0 - b0, a1 - b1, a1 + b1], dim=dim)


def _ls16(device) -> torch.Tensor:
    return torch.as_tensor((16 * T.QUANT_V).reshape(6, 16).T.copy(),
                           dtype=torch.int32, device=device)   # (16, 6)


def _quant_v00(device) -> torch.Tensor:
    return torch.as_tensor(T.QUANT_V[:, 0, 0], dtype=torch.int32,
                           device=device)


def dequant_wide(c: torch.Tensor, qp: torch.Tensor) -> torch.Tensor:
    """8.5.12.1 flat dequant; c (16, N) raster coeffs, qp (N,) int32."""
    ls = _ls16(c.device)[:, qp % 6]                       # (16, N)
    qdiv = qp // 6
    hi = (c * ls) << torch.clamp(qdiv - 4, min=0)
    lo = (c * ls + (1 << torch.clamp(3 - qdiv, min=0))) >> \
        torch.clamp(4 - qdiv, min=0)
    return torch.where(qp >= 24, hi, lo)


def luma_dc_descale_wide(dc: torch.Tensor, qp: torch.Tensor):
    """8.5.10; dc (16, M) raster Hadamard input per MB, qp (M,)."""
    f = _had_stage(_had_stage(dc.reshape(4, 4, -1), 0), 1).reshape(16, -1)
    scale = 16 * _quant_v00(dc.device)[qp % 6]
    qdiv = qp // 6
    hi = (f * scale) << torch.clamp(qdiv - 6, min=0)
    lo = (f * scale + (1 << torch.clamp(5 - qdiv, min=0))) >> \
        torch.clamp(6 - qdiv, min=0)
    return torch.where(qp >= 36, hi, lo)


def chroma_dc_descale_wide(dc: torch.Tensor, qp: torch.Tensor):
    """8.5.11 (4:2:0); dc (4, M) [c00 c01 c10 c11] per MB, qp (M,)."""
    t0, t1 = dc[0] + dc[2], dc[1] + dc[3]
    t2, t3 = dc[0] - dc[2], dc[1] - dc[3]
    f = torch.stack([t0 + t1, t0 - t1, t2 + t3, t2 - t3])
    scale = 16 * _quant_v00(dc.device)[qp % 6]
    return ((f * scale) << (qp // 6)) >> 5


def residual_planes_wide(luma_ac, luma_dc, chroma_ac, chroma_dc, qp,
                         is_i16, chroma_qp_off: int, qpc_table,
                         gw: int, gh: int):
    """Residual decode for (possibly frame-batched) MB buffers.

    luma_ac (M, 16, 16) per-MB, per-blkIdx raster coeffs; luma_dc (M, 16);
    chroma_ac (M, 2, 4, 16); chroma_dc (M, 2, 4); qp (M,) int32; is_i16
    (M,) bool; qpc_table (52,) chroma QP map.  M = B * gh * gw.  Returns
    res_y (B, H, W), res_c (B, 2, H/2, W/2) int32."""
    dev = qp.device
    M = qp.shape[0]
    B = M // (gh * gw)
    NB = M * 16
    X = luma_ac.permute(2, 0, 1).reshape(16, NB)
    d = dequant_wide(X, qp.repeat_interleave(16))
    dcd = luma_dc_descale_wide(luma_dc.T, qp)             # (16, M) raster
    dc_blk = dcd[torch.as_tensor(_BLK_RASTER, device=dev)]
    d0 = torch.where(is_i16[None, :], dc_blk, d[0].reshape(M, 16).T)
    d[0] = d0.T.reshape(NB)
    r = idct_wide(d.reshape(4, 4, NB))
    r = r.reshape(4, 4, M, 16)[:, :, :,
                               torch.as_tensor(_RASTER_TO_BLK, device=dev)]
    r = r.permute(2, 3, 0, 1).reshape(B, gh, gw, 4, 4, 4, 4)
    res_y = r.permute(0, 1, 3, 5, 2, 4, 6).reshape(B, gh * 16, gw * 16)

    qpc = qpc_table[torch.clamp(qp + chroma_qp_off, 0, 51)]
    NC = M * 8
    Xc = chroma_ac.permute(3, 0, 1, 2).reshape(16, NC)
    dc_ = dequant_wide(Xc, qpc.repeat_interleave(8))
    dcc = chroma_dc_descale_wide(
        chroma_dc.permute(2, 0, 1).reshape(4, M * 2),
        qpc.repeat_interleave(2))
    dc_[0] = dcc.reshape(4, M, 2).permute(1, 2, 0).reshape(NC)
    rc = idct_wide(dc_.reshape(4, 4, NC))
    rc = rc.reshape(4, 4, M, 2, 4).permute(2, 3, 4, 0, 1) \
        .reshape(B, gh, gw, 2, 2, 2, 4, 4)
    res_c = rc.permute(0, 3, 1, 4, 6, 2, 5, 7).reshape(B, 2, gh * 8, gw * 8)
    return res_y, res_c


# ---------------------------------------------------------------------------
# Boundary strengths (grid form)
# ---------------------------------------------------------------------------

def compute_bs_grids(mb_is_intra, nnz, mv, ref, fmb_v, fmb_h, fint):
    """Flag-gated bS grids (8.7.2.1): bs_vg[r, c] is the edge LEFT of 4x4
    block (r, c), bs_hg[r, c] the edge ABOVE it, each (..., 4gh, 4gw).
    mb_is_intra/fmb_v/fmb_h/fint (..., gh, gw) bool; nnz/ref (..., 4gh,
    4gw); mv (..., 4gh, 4gw, 2).  Leading batch dims are allowed."""
    gh, gw = mb_is_intra.shape[-2:]
    dev = nnz.device

    def rep(a):
        return a.repeat_interleave(4, -2).repeat_interleave(4, -1)

    bi = rep(mb_is_intra)
    nz = nnz > 0

    def edge_bs(dim):
        intra_pq = bi | torch.roll(bi, 1, dim)
        nz_pq = nz | torch.roll(nz, 1, dim)
        mv_p = torch.roll(mv, 1, dim - 1)
        ref_diff = ref != torch.roll(ref, 1, dim)
        mv_far = ((mv - mv_p).abs() >= 4).any(dim=-1)
        return torch.where(intra_pq, 4,
                           torch.where(nz_pq, 2,
                                       torch.where(mv_far | ref_diff, 1, 0)))

    bs_vg = edge_bs(-1)
    bs_hg = edge_bs(-2)
    internal_v = (torch.arange(4 * gw, device=dev) % 4 != 0)[None, :]
    internal_h = (torch.arange(4 * gh, device=dev) % 4 != 0)[:, None]
    bs_vg = torch.where(internal_v & (bs_vg == 4), 3, bs_vg)
    bs_hg = torch.where(internal_h & (bs_hg == 4), 3, bs_hg)
    fi = rep(fint)
    bs_vg = torch.where(torch.where(internal_v, fi, rep(fmb_v)), bs_vg, 0)
    bs_hg = torch.where(torch.where(internal_h, fi, rep(fmb_h)), bs_hg, 0)
    return bs_vg.to(torch.int32), bs_hg.to(torch.int32)
