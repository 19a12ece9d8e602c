"""Intra mode decision, coefficients and reconstruction as a wavefront over
MB anti-diagonals (torch).

Port of ``hartallo_tpu/encode/intra_encode.py`` (reference
``hl_codec_264_rdo.c:99-300``): SAD + lambda*bits costs of all Intra16x16
and Intra4x4 modes at once, argmin, then transform/quant and recon of the
chosen mode so later blocks predict from true recon.  The ``lax.scan``
over the slope-2 diagonals d = mx + 2*my is a Python loop; one step
handles every MB of a diagonal, and the 16 Intra4x4 blocks of an MB are
16 sequential batched steps.  The f32 costs are formed in the JAX
package's operation order, one tensor op per JAX op.
"""
from __future__ import annotations

from functools import lru_cache

import torch
import torch.nn.functional as F

from hartallo_tpu_torch.core.tables import LUMA_4x4_BLK_XY, QP_SCALE_CHROMA
from hartallo_tpu_torch.decode.intra_recon import (PAD, _neighbor_tile17x25,
                                                   _neighbor_tile9x9)
from hartallo_tpu_torch.encode.me import BIG
from hartallo_tpu_torch.ops.intra import (pred16x16_all, pred4x4_all,
                                          pred_chroma_all)
from hartallo_tpu_torch.ops.transform import (
    chroma_dc_descale, dequant_4x4, forward_dct_4x4,
    forward_hadamard_quant_dc_chroma, forward_hadamard_quant_dc_luma,
    forward_quant_4x4, inverse_transform_4x4, luma_dc_descale_intra16)
from hartallo_tpu_torch.ops.wavefront import (plane_to_tiles, skew,
                                              skew_geometry, tiles_to_plane,
                                              unskew)
from hartallo_tpu_torch.ops.wide import _BLK_RASTER, _RASTER_TO_BLK

_BLK_X = (LUMA_4x4_BLK_XY[:, 0]).astype(int)
_BLK_Y = (LUMA_4x4_BLK_XY[:, 1]).astype(int)
_TR_NEVER = {3, 7, 11, 13, 15}
_TR_EDGE_BLK = 5
# Intra4x4 modes reading the top, left and corner samples (8.3.1.2)
_NEED_TOP = (1, 0, 0, 1, 1, 1, 1, 1, 0)
_NEED_LEFT = (0, 1, 0, 0, 1, 1, 1, 0, 1)
_NEED_TL = (0, 0, 0, 0, 1, 1, 1, 0, 0)


def qpc_of(qp: torch.Tensor, chroma_qp_off: int) -> torch.Tensor:
    """Chroma QP map (8.5.8) of a luma QP tensor."""
    table = torch.as_tensor(QP_SCALE_CHROMA, dtype=torch.int32,
                            device=qp.device)
    return table[torch.clamp(qp + chroma_qp_off, 0, 51).long()]


@lru_cache(maxsize=None)
def _blk_order(device):
    """(raster position of each blkIdx, blkIdx at each raster position)
    on ``device``, made once per device.  Shared: never written."""
    return (torch.as_tensor(_BLK_RASTER, device=device),
            torch.as_tensor(_RASTER_TO_BLK, device=device))


def _blocks_of_mb(mb16: torch.Tensor) -> torch.Tensor:
    """(..., 16, 16) -> (..., 16, 4, 4) in blkIdx order."""
    lead = mb16.shape[:-2]
    r = mb16.reshape(*lead, 4, 4, 4, 4).transpose(-3, -2) \
        .reshape(*lead, 16, 4, 4)
    return r[..., _blk_order(mb16.device)[0], :, :]


def _mb_of_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """(..., 16, 4, 4) in blkIdx order -> (..., 16, 16)."""
    lead = blocks.shape[:-3]
    r = blocks[..., _blk_order(blocks.device)[1], :, :]
    return r.reshape(*lead, 4, 4, 4, 4).transpose(-3, -2) \
        .reshape(*lead, 16, 16)


def chroma_blocks(c8: torch.Tensor) -> torch.Tensor:
    """(..., 8, 8) -> (..., 4, 4, 4): the four 4x4 blocks in raster
    order."""
    lead = c8.shape[:-2]
    return c8.reshape(*lead, 2, 4, 2, 4).transpose(-3, -2) \
        .reshape(*lead, 4, 4, 4)


def chroma_plane(blocks: torch.Tensor) -> torch.Tensor:
    """Inverse of ``chroma_blocks``."""
    lead = blocks.shape[:-3]
    return blocks.reshape(*lead, 2, 2, 4, 4).transpose(-3, -2) \
        .reshape(*lead, 8, 8)


def chroma_residual(resc, qpc, intra: bool):
    """Forward transform and quantisation of (..., 8, 8) chroma residual
    blocks; qpc (...,).  Returns the DC levels (..., 2, 2) and the AC
    levels (..., 4, 4, 4) with the DC slot zero (``chroma_recon`` turns
    them back into samples)."""
    wc = forward_dct_4x4(chroma_blocks(resc))
    dcq = forward_hadamard_quant_dc_chroma(
        wc[..., 0, 0].reshape(*wc.shape[:-3], 2, 2), qpc, intra)
    acq = forward_quant_4x4(wc, qpc[..., None], intra, skip_dc=True)
    return dcq, acq


def chroma_recon(dcq, acq, qpc):
    """Residual samples (..., 8, 8) of quantised chroma DC/AC levels."""
    dcd = chroma_dc_descale(dcq, qpc)
    dd = dequant_4x4(acq, qpc[..., None].expand(acq.shape[:-2]))
    dd[..., 0, 0] = dcd.reshape(*dcd.shape[:-2], 4)
    return chroma_plane(inverse_transform_4x4(dd))


def intra_encode_frame(src_y, src_u, src_v, qp, chroma_qp_off, avail_left,
                       avail_top, lam, avail_tr=None, avail_tl=None,
                       base_planes=None, mb_mask=None, *, gw: int, gh: int):
    """Encode the intra MBs of a frame (every MB on the I-frame path; the
    ``mb_mask`` subset for intra-in-P, whose other MBs pass the
    ``base_planes`` recon through so later MBs predict from the mixed
    inter/intra recon, as the decoder does).

    src_*: PAD-padded int32 source planes; qp (gh,gw) int32; lam f32
    scalar; avail_* (gh,gw) bool.  Returns (recY, recU, recV, arrays):
    zero-padded recon planes and the per-MB arrays use_i16, i16_mode,
    i4_modes, chroma_mode, luma_dc, luma_ac, chroma_dc, chroma_ac."""
    dev = src_y.device
    H, W = gh * 16, gw * 16
    geo = skew_geometry(gw, gh)
    D, K = geo["D"], geo["K"]
    valid = torch.as_tensor(geo["valid"], device=dev)
    lam = torch.as_tensor(lam, dtype=torch.float32, device=dev)
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def sk(a):
        return skew(torch.as_tensor(a, device=dev), geo)

    def sk_flag(a):
        return valid & sk(torch.as_tensor(a, dtype=torch.bool, device=dev))

    def tiles(p, size):
        n = size * gh
        return sk(plane_to_tiles(p[PAD:PAD + n, PAD:PAD + size * gw]
                                 .to(torch.int32), size))

    qp = torch.as_tensor(qp, device=dev).to(torch.int32)
    sy, su, sv = tiles(src_y, 16), tiles(src_u, 8), tiles(src_v, 8)
    if base_planes is None:
        by_t, bu_t, bv_t = (torch.zeros_like(t) for t in (sy, su, sv))
    else:
        by_t, bu_t, bv_t = (tiles(p, s) for p, s in
                            zip(base_planes, (16, 8, 8)))
    ones = torch.ones((gh, gw), dtype=torch.bool, device=dev)
    imask_s = sk_flag(ones if mb_mask is None else mb_mask)
    qp_s, qpc_s = sk(qp), sk(qpc_of(qp, chroma_qp_off))
    al_s, at_s = sk_flag(avail_left), sk_flag(avail_top)
    atr_s = sk_flag(ones if avail_tr is None else avail_tr)
    atl_s = sk_flag(ones if avail_tl is None else avail_tl)
    mxs_s = torch.where(valid, torch.as_tensor(geo["mx_of"], device=dev), -1)

    need_top = torch.as_tensor(_NEED_TOP, dtype=torch.bool, device=dev)
    need_left = torch.as_tensor(_NEED_LEFT, dtype=torch.bool, device=dev)
    need_tl = torch.as_tensor(_NEED_TL, dtype=torch.bool, device=dev)
    bar8 = torch.arange(8, device=dev) >= 4
    ar = torch.arange(K, device=dev)
    blk_raster, blk_from_raster = _blk_order(dev)

    zy = torch.zeros((K, 16, 16), dtype=torch.int32, device=dev)
    zc = torch.zeros((K, 8, 8), dtype=torch.int32, device=dev)
    r1y = r2y = r3y = zy
    r1u = r2u = r3u = r1v = r2v = r3v = zc
    ys = []
    for d in range(D):
        src_tile, csrc = sy[d], (su[d], sv[d])
        imask, qp_mb, qpc_mb = imask_s[d], qp_s[d], qpc_s[d]
        al, at, atr, atl, vld = al_s[d], at_s[d], atr_s[d], atl_s[d], \
            valid[d]
        rec_tile = _neighbor_tile17x25(torch.zeros_like(src_tile), r1y,
                                       r2y, r3y)

        # ---- Intra16x16 path ------------------------------------------
        bank16 = pred16x16_all(rec_tile[:, 0, 1:17], rec_tile[:, 1:17, 0],
                               rec_tile[:, 0, 0], at, al)     # (K,4,16,16)
        sad16 = (bank16 - src_tile[:, None]).abs() \
            .sum(dim=(-1, -2), dtype=torch.int32)
        m16cost = sad16.to(torch.float32)
        m16cost[:, 0] = m16cost[:, 0] + torch.where(at, zero, big)
        m16cost[:, 1] = m16cost[:, 1] + torch.where(al, zero, big)
        m16cost[:, 3] = m16cost[:, 3] + torch.where(at & al & atl, zero, big)
        i16_mode = m16cost.argmin(dim=1)
        i16_cost = m16cost[ar, i16_mode]
        p16 = bank16[ar, i16_mode]
        w16 = forward_dct_4x4(_blocks_of_mb(src_tile - p16))  # (K,16,4,4)
        dc_sp = w16[..., 0, 0][:, blk_from_raster].reshape(K, 4, 4)
        luma_dc_q = forward_hadamard_quant_dc_luma(dc_sp, qp_mb)
        ac16_q = forward_quant_4x4(w16, qp_mb[:, None], True, skip_dc=True)
        d16 = dequant_4x4(ac16_q, qp_mb[:, None].expand(K, 16))
        d16[..., 0, 0] = luma_dc_descale_intra16(luma_dc_q, qp_mb) \
            .reshape(K, 16)[:, blk_raster]
        rec16 = torch.clamp(p16 + _mb_of_blocks(inverse_transform_4x4(d16)),
                            0, 255)

        # ---- Intra4x4 path (16 sequential blocks) ---------------------
        t4 = rec_tile.clone()
        i4_modes, i4_coef = [], []
        i4_cost = torch.zeros((K,), dtype=torch.float32, device=dev)
        at_edge = mxs_s[d] == gw - 1
        for blk in range(16):
            bxp, byp = int(_BLK_X[blk]), int(_BLK_Y[blk])
            x0, y0 = bxp + 1, byp + 1
            top = t4[:, y0 - 1, x0:x0 + 8]
            left = t4[:, y0:y0 + 4, x0 - 1]
            tl = t4[:, y0 - 1, x0 - 1]
            if blk in _TR_NEVER:
                top = torch.where(bar8, top[:, 3:4], top)
            elif blk == _TR_EDGE_BLK:
                top = torch.where((at_edge | ~atr)[:, None] & bar8,
                                  top[:, 3:4], top)
            b_at = at if byp == 0 else vld
            b_al = al if bxp == 0 else vld
            if bxp == 0 and byp == 0:
                b_atl = atl
            elif byp == 0:
                b_atl = at
            elif bxp == 0:
                b_atl = al
            else:
                b_atl = vld
            bank = pred4x4_all(top, left, tl, b_at, b_al)     # (K,9,4,4)
            sblk = src_tile[:, byp:byp + 4, bxp:bxp + 4]
            sad = (bank - sblk[:, None]).abs() \
                .sum(dim=(-1, -2), dtype=torch.int32).to(torch.float32)
            pen = torch.where(need_top[None, :] & ~b_at[:, None], big, zero) \
                + torch.where(need_left[None, :] & ~b_al[:, None], big, zero) \
                + torch.where(need_tl[None, :] & ~b_atl[:, None], big, zero)
            cost = sad + pen + lam * 4.0
            cost[:, 2] = cost[:, 2] + -lam * 3.0  # DC usually cheapest bits
            mode = cost.argmin(dim=1)
            i4_cost = i4_cost + cost[ar, mode]
            pred = bank[ar, mode]
            z = forward_quant_4x4(forward_dct_4x4(sblk - pred), qp_mb, True)
            rec = torch.clamp(
                pred + inverse_transform_4x4(dequant_4x4(z, qp_mb)), 0, 255)
            t4[:, y0:y0 + 4, x0:x0 + 4] = rec
            i4_modes.append(mode)
            i4_coef.append(z)
        rec4 = t4[:, 1:17, 1:17]

        # ---- choose I16 vs I4 -----------------------------------------
        use16 = (i16_cost + lam * 6.0) < i4_cost
        recon = torch.where(use16[:, None, None], rec16, rec4)
        recon = torch.where(imask[:, None, None], recon, by_t[d])

        # ---- chroma ---------------------------------------------------
        banks = []
        for cc, r1, r2, r3 in ((csrc[0], r1u, r2u, r3u),
                               (csrc[1], r1v, r2v, r3v)):
            ct = _neighbor_tile9x9(torch.zeros_like(cc), r1, r2, r3)
            banks.append(pred_chroma_all(ct[:, 0, 1:9], ct[:, 1:9, 0],
                                         ct[:, 0, 0], at, al))
        sadc = sum((b - s[:, None]).abs().sum(dim=(-1, -2),
                                              dtype=torch.int32)
                   for b, s in zip(banks, csrc)).to(torch.float32)
        sadc[:, 2] = sadc[:, 2] + torch.where(at, zero, big)
        sadc[:, 1] = sadc[:, 1] + torch.where(al, zero, big)
        sadc[:, 3] = sadc[:, 3] + torch.where(at & al & atl, zero, big)
        cmode = sadc.argmin(dim=1)
        ch_dc, ch_ac, crecs = [], [], []
        for bankc, cs, base_c in zip(banks, csrc, (bu_t[d], bv_t[d])):
            pc = bankc[ar, cmode]
            dcq, acq = chroma_residual(cs - pc, qpc_mb, True)
            recc = chroma_recon(dcq, acq, qpc_mb)
            crecs.append(torch.where(imask[:, None, None],
                                     torch.clamp(pc + recc, 0, 255), base_c))
            ch_dc.append(dcq)
            ch_ac.append(acq)

        ys.append((use16.to(torch.int32), i16_mode.to(torch.int32),
                   torch.stack(i4_modes, 1).to(torch.int32),
                   cmode.to(torch.int32),
                   torch.where(use16[:, None, None], luma_dc_q, 0),
                   torch.where(use16[:, None, None, None], ac16_q,
                               torch.stack(i4_coef, 1)),
                   torch.stack(ch_dc, 1), torch.stack(ch_ac, 1),
                   recon, crecs[0], crecs[1]))
        r1y, r2y, r3y = recon, r1y, r2y
        r1u, r2u, r3u = crecs[0], r1u, r2u
        r1v, r2v, r3v = crecs[1], r1v, r2v

    (use16, i16_mode, i4_modes, cmode, luma_dc, luma_ac, chroma_dc,
     chroma_ac, rec_y, rec_u, rec_v) = (unskew(torch.stack(a), geo)
                                        for a in zip(*ys))
    arrays = {"use_i16": use16, "i16_mode": i16_mode, "i4_modes": i4_modes,
              "chroma_mode": cmode, "luma_dc": luma_dc, "luma_ac": luma_ac,
              "chroma_dc": chroma_dc, "chroma_ac": chroma_ac}
    recY, recU, recV = (F.pad(tiles_to_plane(r), (PAD, PAD, PAD, PAD))
                        for r in (rec_y, rec_u, rec_v))
    return recY, recU, recV, arrays
