"""P-frame encode on the device (torch): full-search ME -> partition
decision -> sub-pel refine -> MC -> residual transform/quant -> recon.
On CUDA tensors every step is a CUDA kernel: the motion search those of
``encode/me_fast`` (one full search and one launch of both refinement
rounds a picture), the partition decision, the half-pel stack and the
residual those of ``encode/p_body_fast``; on CPU tensors each runs its
plain twin (``encode/me``, and ``partition_decide`` and ``p_residual``
here).

Port of ``hartallo_tpu/encode/p_device.py``, with the JVT-O079 single
coefficient elimination (reference ``hl_codec_264_residual.c:881-897``,
``hl_codec_264_rdo.c:2419, 2641-2647``).  The recon planes stay on the
device; only the coefficient arrays and MVs are fetched for host
packing.
"""
from __future__ import annotations

import torch

from hartallo_tpu_torch.core.tables import ZIGZAG_4x4_INV
from hartallo_tpu_torch.decode.inter_recon import (inter_predict_frame,
                                                   mbs_to_plane, plane_to_mbs)
from hartallo_tpu_torch.decode.intra_recon import PAD
from hartallo_tpu_torch.encode.intra_encode import (_blocks_of_mb,
                                                    _mb_of_blocks,
                                                    chroma_recon,
                                                    chroma_residual, qpc_of)
from hartallo_tpu_torch.encode.me import _PART_OF_BLK, sum4
from hartallo_tpu_torch.encode.me_fast import (
    full_search_int_fast, refine_subpel_rounds_fast)
from hartallo_tpu_torch.encode.p_body_fast import (halfpel_planes_fast,
                                                   p_residual_fast,
                                                   partition_decide_fast)
from hartallo_tpu_torch.ops.math import satd4x4
from hartallo_tpu_torch.ops.transform import (dequant_4x4, forward_dct_4x4,
                                              forward_quant_4x4,
                                              inverse_transform_4x4)
from hartallo_tpu_torch.ops.wide import pad_edge

# JVT-O079 2.3 significance of a lone |level|==1 coefficient by its zigzag
# run; run >= 6 -> 0
_T079 = [3, 2, 2, 1, 1, 1] + [0] * 11
_PARTS = ("16x16", "16x8", "8x16", "8x8")


def eliminate_single_coeffs_luma(wq: torch.Tensor) -> torch.Tensor:
    """JVT-O079 2.3 'elimination of single coefficients in inter
    macroblocks': a whole MB's luma residual is dropped when the summed
    significance of its 4x4 blocks is < 6.  wq (gh, gw, 16, 4, 4)."""
    dev = wq.device
    scanpos = torch.as_tensor(ZIGZAG_4x4_INV.reshape(4, 4), device=dev)
    t079 = torch.as_tensor(_T079, dtype=torch.int32, device=dev)
    az = wq.abs()
    nz = (az > 0).sum(dim=(-2, -1))                         # (gh, gw, 16)
    run = torch.where(az > 0, scanpos, 16).amin(dim=(-2, -1))
    lone1 = (nz == 1) & (az.amax(dim=(-2, -1)) == 1)
    ctr = torch.where(nz == 0, 0,
                      torch.where(lone1, t079[torch.clamp(run, max=16)], 9))
    drop_y = ctr.sum(-1) < 6                                # (gh, gw)
    return torch.where(drop_y[..., None, None, None], 0, wq)


def eliminate_single_coeffs_chroma(acq: torch.Tensor) -> torch.Tensor:
    """JVT-O079 chroma arm: a component whose whole AC set is one lone
    |level|==1 coefficient drops it.  acq (gh, gw, 2, 4, 4, 4), DC slot
    zero."""
    caz = acq.abs()
    cnz = (caz > 0).sum(dim=(-3, -2, -1))                   # (gh, gw, 2)
    lone = (cnz == 1) & (caz.amax(dim=(-3, -2, -1)) == 1)
    return torch.where(lone[..., None, None, None], 0, acq)


def partition_decide(fs, lam, *, gw: int, gh: int):
    """The partition decision from the full search's eight outputs ``fs``
    (``full_search_int``'s order): each scheme's cost with its lambda
    bits, the first minimum, the winning MVs per 4x4 block (raster order,
    quarter-pel) and each block's partition.  Returns (choice int64,
    best_cost f32, mv_blk int32 (gh, gw, 16, 2), part_of_blk int32 (gh,
    gw, 16)).  The plain twin of ``p_body_fast.partition_decide_fast``."""
    (b16c, b16v, b168c, b168v, b816c, b816v, b88c, b88v) = fs
    dev = b16c.device
    lamf = torch.as_tensor(lam, dtype=torch.float32, device=dev)
    c16 = b16c + lamf * 1.0
    c168 = (b168c[..., 0] + b168c[..., 1]) + lamf * 3.0
    c816 = (b816c[..., 0] + b816c[..., 1]) + lamf * 3.0
    c88 = sum4(b88c) + lamf * 9.0
    cost_stack = torch.stack([c16, c168, c816, c88])
    choice = cost_stack.argmin(dim=0)
    best_cost = torch.gather(cost_stack, 0, choice[None])[0]  # (gh, gw)

    def blk_of(vmap_part, scheme):
        pm = torch.as_tensor(_PART_OF_BLK[scheme].reshape(16), device=dev)
        return vmap_part[:, :, pm.long()]                   # (gh,gw,16,2)

    ch = choice[:, :, None, None]
    mv_blk = torch.where(
        ch == 0, b16v[:, :, None, :].expand(gh, gw, 16, 2),
        torch.where(ch == 1, blk_of(b168v, "16x8"),
                    torch.where(ch == 2, blk_of(b816v, "8x16"),
                                blk_of(b88v, "8x8")))) * 4
    pmaps = torch.stack([torch.as_tensor(_PART_OF_BLK[k].reshape(16),
                                         dtype=torch.int32, device=dev)
                         for k in _PARTS])
    return choice, best_cost, mv_blk, pmaps[choice]


def intra_in_p_mask(srcY, inter_cost, lam, gw: int, gh: int):
    """MBs to code intra in a P picture: a conservative source-activity
    estimate (SATD against each 4x4 block's DC, which biases against
    intra) below the inter ME cost."""
    H, W = gh * 16, gw * 16
    src_mb = srcY[PAD:PAD + H, PAD:PAD + W].reshape(gh, 16, gw, 16) \
        .permute(0, 2, 1, 3)
    blk = src_mb.reshape(gh, gw, 4, 4, 4, 4).permute(0, 1, 2, 4, 3, 5) \
        .reshape(gh, gw, 16, 4, 4)
    # the f32 mean of 16 integers, truncated (exact: the sum is < 2^24)
    dc = (blk.sum(dim=(-1, -2), keepdim=True).to(torch.float32) / 16.0) \
        .to(torch.int32)
    intra_est = satd4x4(blk, dc).sum(-1, dtype=torch.int32) \
        .to(torch.float32) + lam * 24.0
    return intra_est < inter_cost


def p_residual(srcY, srcU, srcV, refY, refU, refV, mv_blk, qp, best_cost,
               lam, *, gw: int, gh: int, chroma_qp_off: int,
               intra_in_p: bool):
    """Quarter-pel and chroma MC on the MVs, the luma and chroma residual's
    transform, quantisation (inter dead zone), JVT-O079 eliminations,
    dequantisation, inverse transform and recon, and with ``intra_in_p``
    the intra-in-P mask against ``best_cost``.  Returns (wq, dcq, acq,
    recY, recU, recV, mask): the recon planes edge-padded by PAD; mask
    None without ``intra_in_p``.  The plain twin of
    ``p_body_fast.p_residual_fast``."""
    dev = srcY.device
    H, W = gh * 16, gw * 16
    qp = torch.as_tensor(qp, device=dev).to(torch.int32)
    mv44 = mv_blk.reshape(gh, gw, 4, 4, 2)
    zeros_ref = torch.zeros((gh, gw, 4), dtype=torch.int32, device=dev)
    pred_y, pred_c = inter_predict_frame(refY[None], refU[None], refV[None],
                                         mv44, zeros_ref, gw, gh)

    src_mb = plane_to_mbs(srcY[PAD:PAD + H, PAD:PAD + W].to(torch.int32), 16)
    wq = forward_quant_4x4(forward_dct_4x4(_blocks_of_mb(src_mb - pred_y)),
                           qp[..., None], False)
    wq = eliminate_single_coeffs_luma(wq)
    d = dequant_4x4(wq, qp[..., None].expand(gh, gw, 16))
    rec_y = torch.clamp(pred_y + _mb_of_blocks(inverse_transform_4x4(d)),
                        0, 255)

    qpc = qpc_of(qp, chroma_qp_off)[..., None].expand(gh, gw, 2)
    src_c = torch.stack(
        [plane_to_mbs(p[PAD:PAD + H // 2, PAD:PAD + W // 2]
                      .to(torch.int32), 8) for p in (srcU, srcV)], dim=2)
    dcq, acq = chroma_residual(src_c - pred_c, qpc, False)
    acq = eliminate_single_coeffs_chroma(acq)
    rec_c = torch.clamp(pred_c + chroma_recon(dcq, acq, qpc), 0, 255)

    # edge pad (not zeros): the decoder's reference ring edge-pads, and
    # MC windows clamped into the pad must read identical samples
    recY = pad_edge(mbs_to_plane(rec_y))
    recU = pad_edge(mbs_to_plane(rec_c[:, :, 0]))
    recV = pad_edge(mbs_to_plane(rec_c[:, :, 1]))
    mask = intra_in_p_mask(srcY, best_cost, lam, gw, gh) if intra_in_p \
        else None
    return wq, dcq, acq, recY, recU, recV, mask


def p_frame_device(srcY, srcU, srcV, refY, refU, refV, qp, lam, *, gw: int,
                   gh: int, rng: int, refine: bool, chroma_qp_off: int):
    """Returns (wq, dcq, acq, mv44, choice, recY, recU, recV, best_cost):
    recon planes edge-padded by PAD; best_cost is the winning partition's
    ME cost per MB (the intra-in-P decision input)."""
    return p_frame_with_mask(
        srcY, srcU, srcV, refY, refU, refV, qp, lam, gw=gw, gh=gh, rng=rng,
        refine=refine, chroma_qp_off=chroma_qp_off, intra_in_p=False)[0]


def p_frame_with_mask(srcY, srcU, srcV, refY, refU, refV, qp, lam, *,
                      gw: int, gh: int, rng: int, refine: bool,
                      chroma_qp_off: int, intra_in_p: bool):
    """``p_frame_device``'s outputs and, with ``intra_in_p``, the (gh, gw)
    intra-in-P mask (else None): a full search, a partition decision, one
    launch of both refinement rounds on a half-pel stack (with
    ``refine``) and the residual, each one kernel on a CUDA device."""
    dev = srcY.device
    lamf = torch.as_tensor(lam, dtype=torch.float32, device=dev)
    qp = torch.as_tensor(qp, device=dev).to(torch.int32).contiguous()

    fs = full_search_int_fast(srcY, refY, lamf, gw=gw, gh=gh, rng=rng)
    choice, best_cost, mv_blk, part_of_blk = partition_decide_fast(
        fs, lamf, gw=gw, gh=gh)
    if refine:
        # the half-pel round, then the quarter-pel round on its MVs
        mv_blk, _ = refine_subpel_rounds_fast(
            srcY, refY, mv_blk, part_of_blk, lamf, (2, 1), gw=gw, gh=gh,
            nparts=4, hp=halfpel_planes_fast(refY))
    wq, dcq, acq, recY, recU, recV, mask = p_residual_fast(
        srcY, srcU, srcV, refY, refU, refV, mv_blk, qp, best_cost, lamf,
        gw=gw, gh=gh, chroma_qp_off=chroma_qp_off, intra_in_p=intra_in_p)
    mv44 = mv_blk.reshape(gh, gw, 4, 4, 2)
    return (wq, dcq, acq, mv44, choice, recY, recU, recV, best_cost), mask
