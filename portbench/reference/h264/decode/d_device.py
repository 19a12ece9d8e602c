"""Frame pre-pass of the general decode path (torch): residual decode,
inter / I_BL prediction and the initial planes, whose output the intra
wavefront and the deblock kernel take without a trip to the host.

Port of ``hartallo_tpu/decode/d_device.py`` (one jitted program there;
eager torch ops on the decoder's device here).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.h264.decode.inter_recon import (inter_predict_frame,
                                                   mbs_to_plane)
from portbench.reference.h264.decode.intra_recon import PAD, compute_residuals
from portbench.reference.h264.ops.wide import pad_edge


def _rep(mask, s: int):
    return mask.repeat_interleave(s, 0).repeat_interleave(s, 1)


def decode_frame_pre(luma_ac, luma_dc, chroma_ac, chroma_dc, qp, is_i16,
                     mv, ref_idx, ref_y, ref_u, ref_v,
                     up_y_mb, up_c_mb, kind,
                     pcm_y, pcm_u, pcm_v, weight4x4,
                     res_add_y, res_add_c, rp_mask,
                     *, gw: int, gh: int, has_inter: bool, has_ibl: bool,
                     chroma_qp_off: int, use_weights: bool = False,
                     has_respred: bool = False):
    """kind: (gh, gw) int32 raw mb_kind (0..8); pcm_*: full planes holding
    I_PCM samples (zeros elsewhere); weight4x4: (2, 3, 4, 4) scaling-list
    weightScale (used when use_weights); res_add_y/res_add_c + rp_mask:
    SVC inter-layer residual prediction (G.8.5.3 accumulation: residuals
    sum under clip3(+-255) before reconstruction).  Every tensor on one
    device.  Returns (padY, padU, padV, res_y, res_c)."""
    res_y, res_c = compute_residuals(
        luma_ac, luma_dc, chroma_ac, chroma_dc, qp, is_i16, chroma_qp_off,
        weight4x4=weight4x4 if use_weights else None,
        mb_is_inter=(kind >= 3) & (kind != 8))
    if has_respred:
        # per-MB residual accumulation with the reference-layer rS
        ay = res_add_y.reshape(gh, 16, gw, 16).permute(0, 2, 1, 3)
        ac = res_add_c.reshape(2, gh, 8, gw, 8).permute(1, 3, 0, 2, 4)
        m = rp_mask[:, :, None, None]
        res_y = torch.where(m, torch.clamp(res_y + ay, -255, 255), res_y)
        res_c = torch.where(m[..., None],
                            torch.clamp(res_c + ac, -255, 255), res_c)

    y0, u0, v0 = pcm_y, pcm_u, pcm_v

    def overlay(y0, u0, v0, mask, rec_y_mb, rec_c_mb):
        my, mc = _rep(mask, 16), _rep(mask, 8)
        return (torch.where(my, mbs_to_plane(rec_y_mb), y0),
                torch.where(mc, mbs_to_plane(rec_c_mb[:, :, 0]), u0),
                torch.where(mc, mbs_to_plane(rec_c_mb[:, :, 1]), v0))

    if has_inter:
        pred_y, pred_c = inter_predict_frame(ref_y, ref_u, ref_v, mv,
                                             ref_idx, gw, gh)
        y0, u0, v0 = overlay(y0, u0, v0, (kind >= 3) & (kind != 8),
                             torch.clamp(pred_y + res_y, 0, 255),
                             torch.clamp(pred_c + res_c, 0, 255))
    if has_ibl:
        y0, u0, v0 = overlay(y0, u0, v0, kind == 8,
                             torch.clamp(up_y_mb + res_y, 0, 255),
                             torch.clamp(up_c_mb + res_c, 0, 255))
    return (F.pad(y0, (PAD,) * 4), F.pad(u0, (PAD,) * 4),
            F.pad(v0, (PAD,) * 4), res_y, res_c)


def edge_pad_device(plane_pad: torch.Tensor) -> torch.Tensor:
    """Replace the zero border of a PAD-padded plane with edge replication
    (an MC-ready reference plane), on its device."""
    return pad_edge(plane_pad[PAD:-PAD, PAD:-PAD])


def crop_to_host(plane_pad: torch.Tensor) -> torch.Tensor:
    """The interior of a PAD-padded plane as uint8, on its device (the
    caller fetches it)."""
    return plane_pad[PAD:-PAD, PAD:-PAD].to(torch.uint8)
