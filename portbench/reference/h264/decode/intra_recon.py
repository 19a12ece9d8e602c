"""Residual decode and intra reconstruction as a wavefront over MB
anti-diagonals (torch).

Port of ``compute_residuals``, ``intra_reconstruct`` and
``wavefront_schedule`` of ``hartallo_tpu/decode/intra_recon.py``.
``compute_residuals`` is the frame-batched residual decode of the general
decode path: flat dequant, or the per-MB LevelScale of non-flat scaling
lists (8.5.9), then the inverse transforms.  The wavefront is a Python
loop over the
anti-diagonals d = mx + 2*my (the Intra4x4 top-right dependency forces
slope 2) processes every MB of a diagonal at once, and the 16 Intra4x4
sub-blocks of an MB as 16 sequential batched steps.  The availability
helpers are numpy and copied unchanged (the JAX module imports jax at the
top, so it cannot be imported here).
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.h264.core import tables as T
from portbench.reference.h264.core.tables import LUMA_4x4_BLK_XY, QP_SCALE_CHROMA
from portbench.reference.h264.ops.intra import (pred16x16_all, pred4x4_all,
                                          pred_chroma_all)
from portbench.reference.h264.ops.wavefront import (on_device, plane_to_tiles,
                                              shift_k, skew, skew_geometry,
                                              tiles_to_plane, unskew)
from portbench.reference.h264.ops.transform import (_hadamard_2x2, _hadamard_4x4,
                                              chroma_dc_descale, dequant_4x4,
                                              inverse_transform_4x4,
                                              luma_dc_descale_intra16)

PAD = 32  # plane padding (also the dead-zone target for masked-out writes)

_BLK_X = (LUMA_4x4_BLK_XY[:, 0]).astype(int)   # pixel offsets in MB
_BLK_Y = (LUMA_4x4_BLK_XY[:, 1]).astype(int)
# 4x4 blocks whose top-right neighbour is never available (decode order)
_TR_NEVER = {3, 7, 11, 13, 15}
# blkIdx 5 needs the above-right MB (unavailable at the right frame edge)
_TR_EDGE_BLK = 5


# ---------------------------------------------------------------------------
# Residual assembly (frame-batched)
# ---------------------------------------------------------------------------

def _dequant_w(c, qp, ls):
    """8.5.12.1 with an explicit LevelScale tensor (weightScale applied);
    c (..., 4, 4), qp (...,), ls (..., 4, 4).  Reference
    hl_codec_264_quant.c:68-110."""
    c = c.to(torch.int32)
    qdiv = (qp.to(torch.int32) // 6)[..., None, None]
    hi = (c * ls) << torch.clamp(qdiv - 4, min=0)
    lo = (c * ls + (1 << torch.clamp(3 - qdiv, min=0))) >> \
        torch.clamp(4 - qdiv, min=0)
    return torch.where(qp[..., None, None] >= 24, hi, lo)


def _dc_descale_luma_w(c, qp, scale00):
    """8.5.10 with explicit LevelScale[0][0] (...,) per MB."""
    f = _hadamard_4x4(c.to(torch.int32))
    scale = scale00[..., None, None]
    qdiv = (qp.to(torch.int32) // 6)[..., None, None]
    hi = (f * scale) << torch.clamp(qdiv - 6, min=0)
    lo = (f * scale + (1 << torch.clamp(5 - qdiv, min=0))) >> \
        torch.clamp(6 - qdiv, min=0)
    return torch.where(qp[..., None, None] >= 36, hi, lo)


def _dc_descale_chroma_w(c, qp, scale00):
    """8.5.11 (4:2:0) with explicit LevelScale[0][0] (...,) per MB."""
    f = _hadamard_2x2(c.to(torch.int32))
    return ((f * scale00[..., None, None]) <<
            (qp.to(torch.int32) // 6)[..., None, None]) >> 5


def _luma_plane_of_blocks(r):
    """(gh, gw, 16, 4, 4) blocks in blkIdx order -> (gh, gw, 16, 16)."""
    gh, gw = r.shape[:2]
    res_y = torch.zeros((gh, gw, 16, 16), dtype=torch.int32, device=r.device)
    for blk in range(16):
        res_y[:, :, _BLK_Y[blk]:_BLK_Y[blk] + 4,
              _BLK_X[blk]:_BLK_X[blk] + 4] = r[:, :, blk]
    return res_y


def _chroma_plane_of_blocks(rc):
    """(gh, gw, 2, 4, 4, 4) raster blocks -> (gh, gw, 2, 8, 8)."""
    gh, gw = rc.shape[:2]
    res_c = torch.zeros((gh, gw, 2, 8, 8), dtype=torch.int32,
                        device=rc.device)
    for b in range(4):
        r0, c0 = (b // 2) * 4, (b % 2) * 4
        res_c[:, :, :, r0:r0 + 4, c0:c0 + 4] = rc[:, :, :, b]
    return res_c


def compute_residuals(luma_ac, luma_dc, chroma_ac, chroma_dc, qp,
                      is_i16, chroma_qp_index_offset: int,
                      weight4x4=None, mb_is_inter=None):
    """Returns (res_y (gh, gw, 16, 16), res_c (gh, gw, 2, 8, 8)) int32.

    luma_ac (gh, gw, 16, 4, 4) raster coeffs per blkIdx; luma_dc
    (gh, gw, 4, 4); chroma_ac (gh, gw, 2, 4, 4, 4); chroma_dc
    (gh, gw, 2, 2, 2); qp (gh, gw); is_i16 (gh, gw) bool, all tensors on
    one device.

    weight4x4: optional (2, 3, 4, 4) int32 weightScale tensor (non-flat
    scaling lists, 8.5.9); mb_is_inter (gh, gw) bool then selects the
    list class.  The chroma DC descale indexes the INTRA lists regardless,
    matching the reference (hl_codec_264_transf.c:684-702)."""
    gh, gw = qp.shape
    dev = qp.device
    qp = qp.to(torch.int32)
    qp16 = qp[..., None].expand(gh, gw, 16)
    blk_row = torch.as_tensor(_BLK_Y // 4, device=dev)
    blk_col = torch.as_tensor(_BLK_X // 4, device=dev)
    qpc = torch.as_tensor(QP_SCALE_CHROMA, dtype=torch.int32, device=dev)[
        torch.clamp(qp + chroma_qp_index_offset, 0, 51).long()]
    qpc8 = qpc[..., None, None].expand(gh, gw, 2, 4)
    cr = torch.arange(4, device=dev) // 2
    cc = torch.arange(4, device=dev) % 2

    if weight4x4 is not None:
        LS = weight4x4.to(torch.int32)[:, :, None] * \
            torch.as_tensor(T.QUANT_V, dtype=torch.int32,
                            device=dev)[None, None]      # (2, 3, 6, 4, 4)
        inter = mb_is_inter.long()
        m6 = (qp % 6).long()
        d = _dequant_w(luma_ac, qp16, LS[inter, 0, m6][:, :, None])
        dc = _dc_descale_luma_w(luma_dc, qp, LS[0, 0, m6, 0, 0])
        mc6 = (qpc % 6).long()
        dcc = torch.stack(
            [_dc_descale_chroma_w(chroma_dc[:, :, c], qpc,
                                  LS[0, c + 1, mc6, 0, 0])
             for c in range(2)], dim=2)                  # (gh, gw, 2, 2, 2)
        ls_c = torch.stack([LS[inter, c + 1, mc6] for c in range(2)],
                           dim=2)                        # (gh, gw, 2, 4, 4)
        dac = _dequant_w(chroma_ac, qpc8, ls_c[:, :, :, None])
    else:
        d = dequant_4x4(luma_ac, qp16)
        dc = luma_dc_descale_intra16(luma_dc, qp)        # (gh, gw, 4, 4)
        dcc = chroma_dc_descale(chroma_dc, qpc[..., None])
        dac = dequant_4x4(chroma_ac, qpc8)
    # Intra16x16: replace each block's DC with the descaled Hadamard DC
    # (dc[i][j] belongs to the block at block-row i, block-column j)
    d[..., 0, 0] = torch.where(is_i16[..., None],
                               dc[:, :, blk_row, blk_col], d[..., 0, 0])
    res_y = _luma_plane_of_blocks(inverse_transform_4x4(d))
    dac[..., 0, 0] = dcc[:, :, :, cr, cc]
    res_c = _chroma_plane_of_blocks(inverse_transform_4x4(dac))
    return res_y, res_c


# ---------------------------------------------------------------------------
# Wavefront scheduling (host precompute)
# ---------------------------------------------------------------------------

def wavefront_schedule(gw: int, gh: int):
    """Anti-diagonals d = mx + 2*my; returns (D, M, 2) int32 (my, mx) with
    (-1, -1) padding."""
    D = gw + 2 * gh - 1
    rows = []
    mmax = 0
    for d in range(D):
        mbs = [(my, d - 2 * my) for my in range(gh)
               if 0 <= d - 2 * my < gw]
        mmax = max(mmax, len(mbs))
        rows.append(mbs)
    out = np.full((D, mmax, 2), -1, np.int32)
    for d, mbs in enumerate(rows):
        for k, (my, mx) in enumerate(mbs):
            out[d, k] = (my, mx)
    return out


def _neighbor_tile17x25(cur, r1, r2, r3):
    """(K, 17, 25) bordered tile from the carry rows d-1/d-2/d-3: border
    row -1 = [top-left corner, top MB's bottom row, top-right MB's bottom
    row first 8]; border col -1 = left MB's right column."""
    K = cur.shape[0]
    top, tr, tl = shift_k(r2), shift_k(r1), shift_k(r3)
    row_m1 = torch.cat([tl[:, 15, 15:16], top[:, 15, :], tr[:, 15, 0:8]],
                       dim=1)
    body = torch.cat([r1[:, :, 15:16], cur,
                      torch.zeros((K, 16, 8), dtype=cur.dtype,
                                  device=cur.device)], dim=2)
    return torch.cat([row_m1[:, None, :], body], dim=1)


def _neighbor_tile9x9(cur, r1, r2, r3):
    """Chroma analog: (K, 9, 9) bordered tile from 8x8 carry rows."""
    top, tl = shift_k(r2), shift_k(r3)
    row_m1 = torch.cat([tl[:, 7, 7:8], top[:, 7, :]], dim=1)
    body = torch.cat([r1[:, :, 7:8], cur], dim=2)
    return torch.cat([row_m1[:, None, :], body], dim=1)


def _pick(bank, mode, nmodes):
    """bank (K, n, h, w), mode (K,) -> (K, h, w) with the mode clipped."""
    m = torch.clamp(mode.long(), 0, nmodes - 1)
    return bank[torch.arange(bank.shape[0], device=bank.device), m]


def intra_reconstruct(planes, res_y, res_c, mb_kind, i16_mode, i4_modes,
                      chroma_mode, avail_left, avail_top, avail_tr=None,
                      *, gw: int, gh: int):
    """Run the intra wavefront; returns new padded planes.

    planes: (padY (H+2P, W+2P), padU, padV) int32, pre-filled with the
    inter pixels.  res_y (gh, gw, 16, 16), res_c (gh, gw, 2, 8, 8) int32.
    mb_kind (gh, gw): 0 = I4x4, 1 = I16, others untouched.  avail_*
    (gh, gw) bool (same-slice neighbour availability)."""
    padY, padU, padV = planes
    dev = padY.device
    H, W = gh * 16, gw * 16
    geo = skew_geometry(gw, gh)
    D, K = geo["D"], geo["K"]
    valid = on_device(geo, "valid", dev)
    mx_of = on_device(geo, "mx_of", dev)

    def sk(a):
        return skew(torch.as_tensor(a, device=dev), geo)

    ty = sk(plane_to_tiles(padY[PAD:PAD + H, PAD:PAD + W], 16))
    tu = sk(plane_to_tiles(padU[PAD:PAD + H // 2, PAD:PAD + W // 2], 8))
    tv = sk(plane_to_tiles(padV[PAD:PAD + H // 2, PAD:PAD + W // 2], 8))
    if avail_tr is None:
        avail_tr = torch.ones((gh, gw), dtype=torch.bool, device=dev)
    kind_s = torch.where(valid, sk(mb_kind), -1)
    i16m_s, i4m_s, cm_s = sk(i16_mode), sk(i4_modes), sk(chroma_mode)
    res_y_s, res_c_s = sk(res_y), sk(res_c)
    al_s = valid & sk(avail_left)
    at_s = valid & sk(avail_top)
    atr_s = valid & sk(avail_tr)
    mxs_s = torch.where(valid, mx_of, -1)

    zy = torch.zeros((K, 16, 16), dtype=torch.int32, device=dev)
    zc = torch.zeros((K, 8, 8), dtype=torch.int32, device=dev)
    r1y = r2y = r3y = zy
    r1u = r2u = r3u = r1v = r2v = r3v = zc
    oy, ou, ov = [], [], []
    bar8 = torch.arange(8, device=dev) >= 4
    for d in range(D):
        cy = ty[d].to(torch.int32)
        kind, resy, resc = kind_s[d], res_y_s[d], res_c_s[d]
        al, at, atr = al_s[d], at_s[d], atr_s[d]
        is_i4 = kind == 0
        is_i16 = kind == 1

        tile = _neighbor_tile17x25(cy, r1y, r2y, r3y)
        t4 = tile.clone()
        at_edge = mxs_s[d] == gw - 1
        for blk in range(16):
            x0, y0 = _BLK_X[blk] + 1, _BLK_Y[blk] + 1       # tile coords
            top = t4[:, y0 - 1, x0:x0 + 8]
            left = t4[:, y0:y0 + 4, x0 - 1]
            tl = t4[:, y0 - 1, x0 - 1]
            if blk in _TR_NEVER:
                sub = torch.ones_like(at_edge)
            elif blk == _TR_EDGE_BLK:
                sub = at_edge | ~atr
            else:
                sub = torch.zeros_like(at_edge)
            top = torch.where(sub[:, None] & bar8, top[:, 3:4], top)
            b_at = at if _BLK_Y[blk] == 0 else torch.ones_like(at)
            b_al = al if _BLK_X[blk] == 0 else torch.ones_like(al)
            pred = _pick(pred4x4_all(top, left, tl, b_at, b_al),
                         i4m_s[d][:, blk], 9)
            rb = resy[:, _BLK_Y[blk]:_BLK_Y[blk] + 4,
                      _BLK_X[blk]:_BLK_X[blk] + 4]
            t4[:, y0:y0 + 4, x0:x0 + 4] = torch.clamp(pred + rb, 0, 255)
        interior_i4 = t4[:, 1:17, 1:17]

        p16 = _pick(pred16x16_all(tile[:, 0, 1:17], tile[:, 1:17, 0],
                                  tile[:, 0, 0], at, al), i16m_s[d], 4)
        interior_i16 = torch.clamp(p16 + resy, 0, 255)
        new_y = torch.where(is_i4[:, None, None], interior_i4,
                            torch.where(is_i16[:, None, None],
                                        interior_i16, cy))

        new_c = []
        for pi, (cc, r1, r2, r3) in enumerate(
                ((tu[d].to(torch.int32), r1u, r2u, r3u),
                 (tv[d].to(torch.int32), r1v, r2v, r3v))):
            ct = _neighbor_tile9x9(cc, r1, r2, r3)
            pc = _pick(pred_chroma_all(ct[:, 0, 1:9], ct[:, 1:9, 0],
                                       ct[:, 0, 0], at, al), cm_s[d], 4)
            recc = torch.clamp(pc + resc[:, pi], 0, 255)
            new_c.append(torch.where((is_i4 | is_i16)[:, None, None],
                                     recc, cc))
        new_u, new_v = new_c
        r1y, r2y, r3y = new_y, r1y, r2y
        r1u, r2u, r3u = new_u, r1u, r2u
        r1v, r2v, r3v = new_v, r1v, r2v
        oy.append(new_y)
        ou.append(new_u)
        ov.append(new_v)

    out = []
    for pad, o, s in ((padY, oy, 16), (padU, ou, 8), (padV, ov, 8)):
        p = pad.to(torch.int32).clone()
        p[PAD:PAD + gh * s, PAD:PAD + gw * s] = \
            tiles_to_plane(unskew(torch.stack(o), geo))
        out.append(p)
    return tuple(out)


# ---------------------------------------------------------------------------
# Availability masks (host numpy, copied from the JAX package)
# ---------------------------------------------------------------------------

def availability_masks(slice_id: np.ndarray, constrained: bool,
                       mb_is_inter: np.ndarray):
    """Returns (avail_left, avail_top) bool (gh, gw) for intra prediction.

    A neighbour is available if it exists, lies in the same slice, and,
    with constrained_intra_pred, is not inter-coded (6.4.9 + 8.3.1)."""
    gh, gw = slice_id.shape
    same_l = np.zeros((gh, gw), bool)
    same_t = np.zeros((gh, gw), bool)
    same_l[:, 1:] = (slice_id[:, 1:] == slice_id[:, :-1]) & \
        (slice_id[:, 1:] >= 0)
    same_t[1:, :] = (slice_id[1:, :] == slice_id[:-1, :]) & \
        (slice_id[1:, :] >= 0)
    if constrained:
        inter_l = np.zeros((gh, gw), bool)
        inter_t = np.zeros((gh, gw), bool)
        inter_l[:, 1:] = mb_is_inter[:, :-1]
        inter_t[1:, :] = mb_is_inter[:-1, :]
        same_l &= ~inter_l
        same_t &= ~inter_t
    return same_l, same_t


def availability_tl(slice_id: np.ndarray, constrained: bool,
                    mb_is_inter: np.ndarray) -> np.ndarray:
    """Top-left MB availability (gh, gw) (6.4.9)."""
    gh, gw = slice_id.shape
    tl = np.zeros((gh, gw), bool)
    tl[1:, 1:] = (slice_id[:-1, :-1] == slice_id[1:, 1:]) & \
        (slice_id[1:, 1:] >= 0)
    if constrained:
        tl[1:, 1:] &= ~mb_is_inter[:-1, :-1]
    return tl


def availability_tr(slice_id: np.ndarray, constrained: bool,
                    mb_is_inter: np.ndarray) -> np.ndarray:
    """Above-right MB availability (gh, gw): Intra4x4 blk 5 reads the
    above-right MB's bottom row, unavailable across a slice boundary."""
    gh, gw = slice_id.shape
    tr = np.zeros((gh, gw), bool)
    tr[1:, :-1] = (slice_id[:-1, 1:] == slice_id[1:, :-1]) & \
        (slice_id[1:, :-1] >= 0)
    if constrained:
        tr[1:, :-1] &= ~mb_is_inter[:-1, 1:]
    return tr
