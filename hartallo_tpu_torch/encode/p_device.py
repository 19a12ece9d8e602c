"""P-frame encode on the device (torch): full-search ME -> partition
decision -> sub-pel refine -> MC -> residual transform/quant -> recon.

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
from hartallo_tpu_torch.encode.me import (_PART_OF_BLK, full_search_int,
                                          refine_subpel, sum4)
from hartallo_tpu_torch.ops.transform import (dequant_4x4, forward_dct_4x4,
                                              forward_quant_4x4,
                                              inverse_transform_4x4)
from hartallo_tpu_torch.ops.wide import halfpel_planes, pad_edge

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


def p_frame_device(srcY, srcU, srcV, refY, refU, refV, qp, lam, *, gw: int,
                   gh: int, rng: int, refine: bool, chroma_qp_off: int):
    """Returns (wq, dcq, acq, mv44, choice, recY, recU, recV, best_cost):
    recon planes edge-padded by PAD; best_cost is the winning partition's
    ME cost per MB (the intra-in-P decision input)."""
    dev = srcY.device
    H, W = gh * 16, gw * 16
    lamf = torch.as_tensor(lam, dtype=torch.float32, device=dev)
    qp = torch.as_tensor(qp, device=dev).to(torch.int32)

    (b16c, b16v, b168c, b168v, b816c, b816v, b88c, b88v) = \
        full_search_int(srcY, refY, lamf, gw=gw, gh=gh, rng=rng)
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
                                         device=dev) for k in _PARTS])
    part_of_blk = pmaps[choice]

    if refine:
        hp = halfpel_planes(refY)           # shared by both rounds
        mv_blk, _ = refine_subpel(srcY, refY, mv_blk, part_of_blk, lamf, 2,
                                  gw=gw, gh=gh, nparts=4, hp=hp)
        mv_blk, _ = refine_subpel(srcY, refY, mv_blk, part_of_blk, lamf, 1,
                                  gw=gw, gh=gh, nparts=4, hp=hp)

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
    return wq, dcq, acq, mv44, choice, recY, recU, recV, best_cost
