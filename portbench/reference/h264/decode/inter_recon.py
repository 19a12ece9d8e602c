"""Batched inter prediction of a whole P frame (torch).

Port of ``hartallo_tpu/decode/inter_recon.py``: given the MV field, inter
prediction has no spatial dependencies, so every 4x4 luma block and 2x2
chroma block of the frame is one batched MC pass
(``ops/interpol.luma_mc_blocks`` / ``chroma_mc_blocks``).
"""
from __future__ import annotations

import torch

from portbench.reference.h264.ops.interpol import chroma_mc_blocks, \
    luma_mc_blocks
from portbench.reference.h264.ops.wide import mc_grids


def inter_predict_frame(ref_y_stack, ref_u_stack, ref_v_stack, mv, ref_idx,
                        gw: int, gh: int):
    """mv (gh, gw, 4, 4, 2) quarter-pel MVs ([by][bx] raster); ref_idx
    (gh, gw, 4) per-8x8 L0 reference indices; ref_*_stack (R, Hp, Wp)
    padded reference planes.  Returns pred_y (gh, gw, 16, 16), pred_c
    (gh, gw, 2, 8, 8) int32."""
    dev = ref_y_stack.device
    n = gh * gw * 16
    mvf = torch.as_tensor(mv, device=dev).to(torch.int32).reshape(n, 2)
    ref44 = torch.as_tensor(ref_idx, device=dev).to(torch.int32) \
        .reshape(gh, gw, 2, 2).repeat_interleave(2, 2).repeat_interleave(2, 3)
    reff = ref44.reshape(n)
    bx, by, cbx, cby = mc_grids(gw, gh, dev)

    pred = luma_mc_blocks(ref_y_stack, bx, by, mvf[:, 0], mvf[:, 1], reff)
    pred_y = pred.reshape(gh, gw, 4, 4, 4, 4).permute(0, 1, 2, 4, 3, 5) \
        .reshape(gh, gw, 16, 16)
    preds_c = []
    for stack in (ref_u_stack, ref_v_stack):
        pc = chroma_mc_blocks(stack, cbx, cby, mvf[:, 0], mvf[:, 1], reff)
        preds_c.append(pc.reshape(gh, gw, 4, 4, 2, 2)
                       .permute(0, 1, 2, 4, 3, 5).reshape(gh, gw, 8, 8))
    return pred_y, torch.stack(preds_c, dim=2)


def mbs_to_plane(mbs: torch.Tensor) -> torch.Tensor:
    """(gh, gw, S, S) MB tiles -> (gh*S, gw*S) plane."""
    gh, gw, S, _ = mbs.shape
    return mbs.permute(0, 2, 1, 3).reshape(gh * S, gw * S)


def plane_to_mbs(plane: torch.Tensor, S: int) -> torch.Tensor:
    """(gh*S, gw*S) plane -> (gh, gw, S, S) MB tiles."""
    H, W = plane.shape
    return plane.reshape(H // S, S, W // S, S).permute(0, 2, 1, 3)
