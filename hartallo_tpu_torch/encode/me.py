"""Motion estimation as batched SAD reductions over the candidate grid
(torch).

Port of ``hartallo_tpu/encode/me.py``: integer full search over all
(2R+1)^2 offsets, 32 candidates a step, each a whole-frame |src - ref|
reduced to per-8x8 SADs from which the 16x16/16x8/8x16/8x8 partition costs
are sums; then 9-point sub-pel refinement rounds (half, quarter) at
4x4-block granularity with SATD and per-partition aggregation.

Byte identity with the JAX package rests on three rules here:

- every f32 cost is formed in JAX's operation order, one tensor op per
  JAX op, and sums of four f32 values run left to right as XLA's do;
  where XLA on the CPU contracts a multiply and an add into one fused
  multiply-add (an array times an array, added in the same loop), the
  port rounds once too (``fma_f32``);
- ``_se_bits`` counts bits with integers (the JAX ``floor(log2(f32))``
  is exact over every MV component the search produces; the tests pin
  both);
- partition sums are integer sums cast to f32, never a float matmul.
"""
from __future__ import annotations

import numpy as np
import torch

from hartallo_tpu_torch.ops.interpol import PAD
from hartallo_tpu_torch.ops.math import satd4x4
from hartallo_tpu_torch.ops.wide import halfpel_planes, mc_grids, \
    mc_luma_plane

BIG = 1e18           # cost of a masked candidate or mode (f32 1e18)
CHUNK = 32           # candidates per full-search step


def _bit_len_m1(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) of positive int tensors (x < 2^31), by counting the
    powers of two 2^1..2^30 at or below x."""
    pow2 = torch.as_tensor([1 << k for k in range(1, 31)],
                           dtype=torch.int64, device=x.device)
    return (x.to(torch.int64)[..., None] >= pow2).sum(-1)


def se_bits_int(v: torch.Tensor) -> torch.Tensor:
    """Exp-Golomb signed code length of v, int64: codeNum 2|v| (or
    2|v| - 1), length 2 floor(log2(2|v| + 1)) + 1."""
    return 2 * _bit_len_m1(2 * v.to(torch.int64).abs() + 1) + 1


def _se_bits(v: torch.Tensor) -> torch.Tensor:
    """``se_bits_int`` as f32, the JAX ``_se_bits`` value."""
    return se_bits_int(v).to(torch.float32)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """f32 a * b + c rounded once, as a fused multiply-add: the product of
    two f32 values is exact in f64, and so is its sum with c for the
    costs here (an integer below 2^24 plus a product of at most 48
    significant bits spanning under 53), so one rounding to f32 remains."""
    return (c.to(torch.float64) + a.to(torch.float64) *
            b.to(torch.float64)).to(torch.float32)


def sum4(x: torch.Tensor) -> torch.Tensor:
    """Sum over a last dim of 4, left to right (XLA's order on the CPU)."""
    return ((x[..., 0] + x[..., 1]) + x[..., 2]) + x[..., 3]


def full_search_int(src_pad, ref_pad, lam_motion, *, gw: int, gh: int,
                    rng: int):
    """Integer full search.  Returns per-partition best integer MVs (pel
    units) and costs, as the JAX function:
      mv16 (gh,gw,2), c16 (gh,gw); mv168 (gh,gw,2,2), c168 (gh,gw,2);
      mv816 (gh,gw,2,2), c816 (gh,gw,2); mv88 (gh,gw,4,2), c88 (gh,gw,4)
    in the order (c16, mv16, c168, mv168, c816, mv816, c88, mv88).  Costs
    are f32 SAD + lam_motion * mvd-bits with a zero MV predictor."""
    dev = ref_pad.device
    H, W = gh * 16, gw * 16
    side = 2 * rng + 1
    C = side * side
    n_chunks = (C + CHUNK - 1) // CHUNK
    lam = torch.as_tensor(lam_motion, dtype=torch.float32, device=dev)
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)

    src = src_pad[PAD:PAD + H, PAD:PAD + W].to(torch.int32)
    ref = ref_pad.to(torch.int32).contiguous()
    Wp = ref.shape[1]
    # every candidate window: win[dy + rng, dx + rng] = ref shifted by
    # (dy, dx), a view of the padded plane
    win = ref.as_strided((side, side, H, W), (Wp, 1, Wp, 1),
                         ref.storage_offset() + (PAD - rng) * Wp +
                         (PAD - rng))

    best = [torch.full((gh, gw), BIG, dtype=torch.float32, device=dev),
            torch.zeros((gh, gw, 2), dtype=torch.int32, device=dev),
            torch.full((gh, gw, 2), BIG, dtype=torch.float32, device=dev),
            torch.zeros((gh, gw, 2, 2), dtype=torch.int32, device=dev),
            torch.full((gh, gw, 2), BIG, dtype=torch.float32, device=dev),
            torch.zeros((gh, gw, 2, 2), dtype=torch.int32, device=dev),
            torch.full((gh, gw, 4), BIG, dtype=torch.float32, device=dev),
            torch.zeros((gh, gw, 4, 2), dtype=torch.int32, device=dev)]
    for i in range(n_chunks):
        cs = torch.arange(i * CHUNK, (i + 1) * CHUNK, device=dev)
        cc = torch.clamp(cs, max=C - 1)
        dy = torch.div(cc, side, rounding_mode="floor") - rng
        dx = cc % side - rng
        shifted = win[dy + rng, dx + rng]                   # (CH, H, W)
        s8 = (src - shifted).abs().reshape(CHUNK, 2 * gh, 8, 2 * gw, 8) \
            .sum(dim=(2, 4), dtype=torch.int32)             # (CH,2gh,2gw)
        pen = lam * (_se_bits(dx * 4) + _se_bits(dy * 4))
        pen = torch.where(cs < C, pen, big)                 # mask padding
        q = s8.reshape(CHUNK, gh, 2, gw, 2).permute(0, 1, 3, 2, 4)
        s88 = q.reshape(CHUNK, gh, gw, 4).to(torch.float32) + \
            pen[:, None, None, None]
        s16 = sum4(s88)
        s168 = torch.stack([s88[..., 0] + s88[..., 1],
                            s88[..., 2] + s88[..., 3]], -1)
        s816 = torch.stack([s88[..., 0] + s88[..., 2],
                            s88[..., 1] + s88[..., 3]], -1)
        mv = torch.stack([dx, dy], -1).to(torch.int32)      # (CH, 2)
        for j, cost in enumerate((s16, s168, s816, s88)):
            # best over the chunk (first minimum), then strictly better
            # than the carry, so ties keep the earlier candidate
            k = cost.argmin(dim=0)
            cmin = torch.gather(cost, 0, k[None])[0]
            better = cmin < best[2 * j]
            best[2 * j] = torch.where(better, cmin, best[2 * j])
            best[2 * j + 1] = torch.where(better[..., None], mv[k],
                                          best[2 * j + 1])
    return tuple(best)


# 4x4 blocks (by,bx raster) -> partition index per partition scheme
_PART_OF_BLK = {
    "16x16": np.zeros((4, 4), np.int32),
    "16x8": np.repeat(np.arange(2), 2)[:, None] * np.ones((1, 4), np.int32),
    "8x16": np.ones((4, 1), np.int32) * np.repeat(np.arange(2), 2)[None, :],
    "8x8": (np.repeat(np.arange(2), 2)[:, None] * 2 +
            np.repeat(np.arange(2), 2)[None, :]),
}

_DELTAS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1),
           (-1, -1), (1, -1), (-1, 1), (1, 1))


def _per_block(plane: torch.Tensor, gw: int, gh: int) -> torch.Tensor:
    """(H, W) -> (gh, gw, 16, 4, 4) in (my, mx, by, bx) block order."""
    return plane.reshape(gh, 4, 4, gw, 4, 4).permute(0, 3, 1, 4, 2, 5) \
        .reshape(gh, gw, 16, 4, 4)


def refine_subpel(src_pad, ref_pad, mv_blk, part_of_blk, lam_motion,
                  step_qpel: int, *, gw: int, gh: int, nparts: int,
                  use_satd: bool = True, hp=None):
    """One 9-point refinement round at +-step_qpel quarter-pel units.

    mv_blk (gh,gw,16,2) quarter-pel MVs per 4x4 block; part_of_blk
    (gh,gw,16) partition id in [0, nparts).  Candidates are predicted
    from the half-pel stack (``hp``: optional precomputed
    ``halfpel_planes(ref_pad)``).  Returns the updated mv_blk and the
    per-partition cost (gh,gw,nparts) f32."""
    dev = mv_blk.device
    H, W = gh * 16, gw * 16
    n = gh * gw * 16
    lam = torch.as_tensor(lam_motion, dtype=torch.float32, device=dev)
    if hp is None:
        hp = halfpel_planes(ref_pad)
    hp = hp[None] if hp.dim() == 3 else hp                  # (1,4,Hp,Wp)
    bx, by, _, _ = mc_grids(gw, gh, dev)
    slot = torch.zeros((n,), dtype=torch.int32, device=dev)
    wp_id = torch.zeros((n, 3), dtype=torch.int32, device=dev)
    wp_id[:, 0] = 1
    src_blocks = _per_block(src_pad[PAD:PAD + H, PAD:PAD + W]
                            .to(torch.int32), gw, gh)
    part = part_of_blk.to(torch.int64)
    mv_blk = mv_blk.to(torch.int32)
    mvf = mv_blk.reshape(n, 2)

    def per_part(v):
        """(gh,gw,16) int -> exact per-partition sums (gh,gw,nparts)."""
        return torch.zeros((gh, gw, nparts), dtype=torch.int64,
                           device=dev).scatter_add_(2, part, v.long())

    count = per_part(torch.ones_like(part)).to(torch.float32)
    costs = []
    for ddx, ddy in _DELTAS:
        pred = mc_luma_plane(hp, slot, bx, by, mvf[:, 0] + ddx * step_qpel,
                             mvf[:, 1] + ddy * step_qpel, wp_id, gw, gh)
        pb = _per_block(pred, gw, gh)
        if use_satd:
            sad = satd4x4(pb, src_blocks)
        else:
            sad = (pb - src_blocks).abs().sum(dim=(-1, -2))
        psad = per_part(sad).to(torch.float32)
        # rate term: bits of the refined MV (zero-pred approximation)
        bits = se_bits_int(mv_blk[..., 0] + ddx * step_qpel) + \
            se_bits_int(mv_blk[..., 1] + ddy * step_qpel)
        pbits = per_part(bits).to(torch.float32) / \
            torch.clamp(count, min=1.0)
        # XLA fuses this multiply-add (an FMA on the CPU)
        costs.append(fma_f32(lam, pbits, psad))
    cost_stack = torch.stack(costs)                         # (9,gh,gw,np)
    best = cost_stack.argmin(dim=0)                         # (gh,gw,np)
    best_cost = torch.gather(cost_stack, 0, best[None])[0]
    dxs = torch.as_tensor([d[0] for d in _DELTAS], dtype=torch.int32,
                          device=dev)
    dys = torch.as_tensor([d[1] for d in _DELTAS], dtype=torch.int32,
                          device=dev)
    dd_blk = torch.stack([torch.gather(dxs[best], 2, part),
                          torch.gather(dys[best], 2, part)], dim=-1)
    return mv_blk + dd_blk * step_qpel, best_cost
