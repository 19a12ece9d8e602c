"""The GOP scan's residual decode, motion compensation and ring write as
three CUDA kernel launches, and their plain twins.

Counterparts of the XLA of ``hartallo_tpu/decode/d_gop.py``'s scan, in
``csrc/mc_decode.cu``:

- ``residual_planes_fast`` -> ``hl_residual_dec``, one launch for the K
  pictures of a batch, on their int16 records as uploaded; twin
  ``residual_planes_plain``, the fields of the dense buffer through
  ``ops/wide.residual_planes_wide`` (the flat dequant, the luma and
  chroma DC, the inverse transform), a luma block's levels only where
  its TotalCoeff is above 0;
- ``mc_recon_fast`` -> ``hl_mc_dec``, one launch a picture; twin
  ``mc_recon_plain`` (``ops/wide.mc_luma_plane`` and ``mc_chroma_plane``,
  the residual added and clipped where the MB is inter, 0 elsewhere, the
  zero pad);
- ``ring_write_fast`` -> ``hl_ring_write_dec``, one launch a picture;
  twin ``ring_write_plain`` (the half-pel stack of the edge-padded luma
  and the edge-padded chroma into a ring slot as bytes, zeros in its
  margin, and the picture's output row).

The GOP scan (``d_gop.prepare_pictures``, ``reconstruct_picture``,
``decode_gop``), the sharded band step (residual and MC through the same
body) and the SVC encoder's inter-layer prediction
(``encode/svc._ilp_predict``: MC alone) call them.  On CUDA tensors a
wrapper launches its kernel on the current CUDA stream and adds one to
its entry of ``LAUNCHES``; on CPU tensors it runs the twin.  There is no
other branch: a failed build or launch raises, and on CUDA tensors the
wrappers convert nothing (another dtype, shape, stride or alignment than
the kernel takes raises ``ValueError``).
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from hartallo_tpu_torch.core.tables import QP_SCALE_CHROMA
from hartallo_tpu_torch.decode.intra_recon import PAD
from hartallo_tpu_torch.encode.me_fast import _check, _device
from hartallo_tpu_torch.encode.p_body_fast import _on, _stream, _tensor
from hartallo_tpu_torch.ops.deblock_fast import check_record
from hartallo_tpu_torch.ops.wide import (halfpel_planes, mc_chroma_plane,
                                         mc_grids, mc_luma_plane, pad_edge,
                                         residual_planes_wide)

# kernel launches in this process, by wrapper
LAUNCHES = {"residual_dec": 0, "mc_dec": 0, "ring_write_dec": 0}
# the per-MB int16 words the residual reads, as (name, shape) in the order
# of ``d_fused.DEC_FIELDS``; the kernel reads the five arrays as 8-byte
# vectors, so their offsets and the record's words are multiples of 4
RESIDUAL_FIELDS = (("luma_ac", (16, 4, 4)), ("luma_dc", (4, 4)),
                   ("chroma_ac", (2, 4, 4, 4)), ("chroma_dc", (2, 2, 2)),
                   ("qp", ()), ("kind", ()), ("nnz", (4, 4)))
# blkIdx b -> the raster index of its 4x4 block
_BLK_RASTER = torch.tensor([((b >> 3) << 3) | (((b >> 1) & 1) << 2) |
                            (((b >> 2) & 1) << 1) | (b & 1)
                            for b in range(16)])


def residual_planes_plain(rec, offsets, chroma_qp_off: int, *, gw: int,
                          gh: int):
    """The plain twin of ``residual_planes_fast``: the record's fields,
    widened to int32, through ``residual_planes_wide``; a luma block's
    levels count only where its TotalCoeff (``nnz``) is above 0, as the
    parser leaves them (an uncoded block's levels are 0).  Returns res_y
    (K, H, W), res_c (K, 2, H/2, W/2) int32."""
    check_record("residual_planes_plain", rec, gw, gh, offsets,
                 RESIDUAL_FIELDS)
    M = rec.shape[0] * rec.shape[1]
    f = {}
    for (name, shape), o in zip(RESIDUAL_FIELDS, offsets):
        n = int(np.prod(shape, dtype=int)) if shape else 1
        f[name] = rec[:, :, o:o + n].reshape(M, n).to(torch.int32)
    coded = (f["nnz"] > 0)[:, _BLK_RASTER.to(rec.device)]
    qpc_table = torch.as_tensor(QP_SCALE_CHROMA, dtype=torch.int32,
                                device=rec.device)
    return residual_planes_wide(
        (f["luma_ac"].reshape(M, 16, 16) * coded[..., None]),
        f["luma_dc"], f["chroma_ac"].reshape(M, 2, 4, 16),
        f["chroma_dc"].reshape(M, 2, 4), f["qp"].reshape(M),
        (f["kind"] == 1).reshape(M), chroma_qp_off, qpc_table, gw, gh)


def residual_planes_fast(rec, offsets, chroma_qp_off: int, *, gw: int,
                         gh: int):
    """The residual planes of K pictures from their per-MB records: rec
    (K, gh*gw, words) int16, contiguous, as the host parsed them, with
    ``RESIDUAL_FIELDS`` at ``offsets`` (``ops/deblock_fast
    .record_offsets(fields, RESIDUAL_FIELDS)``; the arrays' offsets and
    words multiples of 4); every MB's qp in 0..51.  CUDA tensors -> one
    ``hl_residual_dec`` launch; CPU tensors -> ``residual_planes_plain``.
    Another dtype, shape or layout raises ``ValueError`` on either.
    Returns res_y (K, H, W), res_c (K, 2, H/2, W/2) int32."""
    name = "residual_planes_fast"
    check_record(name, rec, gw, gh, offsets, RESIDUAL_FIELDS)
    device = _device(name, (rec,))
    if device is None:
        return residual_planes_plain(rec, offsets, chroma_qp_off, gw=gw,
                                     gh=gh)
    from hartallo_tpu_torch import kernels
    K, _, words = rec.shape
    if (words | offsets[0] | offsets[1] | offsets[2] | offsets[3] |
            offsets[6]) % 4 or rec.data_ptr() % 8:
        raise ValueError(f"{name}: {words} words a record, offsets "
                         f"{tuple(offsets)}; the kernel reads 8-byte "
                         "vectors: words and the arrays' offsets must be "
                         "multiples of 4, the data 8-byte aligned")
    H, W = gh * 16, gw * 16
    flat = torch.empty(K * H * W * 3 // 2, dtype=torch.int32, device=device)
    res_y = flat[:K * H * W].view(K, H, W)
    res_c = flat[K * H * W:].view(K, 2, H // 2, W // 2)
    offs = (ctypes.c_int * len(offsets))(*offsets)
    with _on(device):
        rc = kernels.load().hl_residual_dec(
            rec.data_ptr(), words, offs, res_y.data_ptr(), res_c.data_ptr(),
            K, gw, gh, int(chroma_qp_off), _stream(device))
    _check(rc, "hl_residual_dec")
    LAUNCHES["residual_dec"] += 1
    return res_y, res_c


def mc_recon_plain(stackY, ringU, ringV, mv, slot, wp_l, wp_c, res_y,
                   res_c, inter, *, gw: int, gh: int):
    """The plain twin of ``mc_recon_fast``: ``mc_luma_plane`` and
    ``mc_chroma_plane`` (twice), the residual added and clipped where the
    MB is inter and 0 elsewhere, each plane padded with PAD zeros."""
    bx, by, cbx, cby = mc_grids(gw, gh, stackY.device)
    pY = mc_luma_plane(stackY, slot, bx, by, mv[:, 0], mv[:, 1], wp_l, gw,
                       gh)
    pU = mc_chroma_plane(ringU, slot, cbx, cby, mv[:, 0], mv[:, 1],
                         wp_c[:, 0], gw, gh)
    pV = mc_chroma_plane(ringV, slot, cbx, cby, mv[:, 0], mv[:, 1],
                         wp_c[:, 1], gw, gh)
    mask_y = inter.repeat_interleave(16, -2).repeat_interleave(16, -1)
    mask_c = inter.repeat_interleave(8, -2).repeat_interleave(8, -1)
    zero = torch.zeros((), dtype=torch.int32, device=stackY.device)
    return tuple(
        torch.nn.functional.pad(
            torch.where(msk, torch.clamp(p + r, 0, 255), zero),
            (PAD, PAD, PAD, PAD))
        for p, r, msk in ((pY, res_y, mask_y), (pU, res_c[0], mask_c),
                          (pV, res_c[1], mask_c)))


def _stack(t, dims: int, dtype, name: str) -> None:
    if t.dtype != dtype or t.dim() != dims or not t.is_contiguous():
        raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}; it needs a "
                         f"contiguous {dims}-D {dtype} tensor")


@lru_cache(maxsize=None)
def _mc_layout(gw: int, gh: int):
    """The MC kernel's three padded int32 planes as (shape, offset) in one
    allocation of the returned length, each 16-byte aligned (every size
    is a multiple of 4 samples)."""
    luma = (gh * 16 + 2 * PAD, gw * 16 + 2 * PAD)
    chroma = (gh * 8 + 2 * PAD, gw * 8 + 2 * PAD)
    n_y, n_c = luma[0] * luma[1], chroma[0] * chroma[1]
    return n_y + 2 * n_c, ((luma, 0), (chroma, n_y), (chroma, n_y + n_c))


def mc_recon_fast(stackY, ringU, ringV, mv, slot, wp_l, wp_c, res_y, res_c,
                  inter, *, gw: int, gh: int):
    """One picture's inter prediction plus residual, as the three
    PAD-padded int32 planes (Y, U, V) that the intra wavefront and the
    deblock take: quarter-pel luma from each 4x4 block's slot of stackY
    (S, 4, Hs, Ws) [G, b, h, j], eighth-pel chroma from ringU/ringV (S,
    Hcs, Wcs) (any dims at least the padded picture's, read as strides;
    uint8 or int32, both the same), weighted by the block's [w, o,
    logWD] (logWD in 0..7), plus the residual, clipped; 0 in an MB that
    is not inter and in the pad.  mv (N, 2), slot (N,), wp_l (N, 3) and
    wp_c (N, 2, 3) int32 per 4x4 block, N = gh*gw*16 ordered (my, mx, by,
    bx); res_y (H, W), res_c (2, H/2, W/2) int32, 16-byte aligned; inter
    (gh, gw) bool.  CUDA tensors -> one ``hl_mc_dec`` launch; CPU tensors
    -> ``mc_recon_plain``."""
    name = "mc_recon_fast"
    args = (stackY, ringU, ringV, mv, slot, wp_l, wp_c, res_y, res_c, inter)
    device = _device(name, args)
    if device is None:
        return mc_recon_plain(*args, gw=gw, gh=gh)
    from hartallo_tpu_torch import kernels
    H, W, N = gh * 16, gw * 16, gh * gw * 16
    if stackY.dtype not in (torch.uint8, torch.int32):
        raise ValueError(f"{name}: stackY is {stackY.dtype}; it needs uint8 "
                         "or int32")
    _stack(stackY, 4, stackY.dtype, f"{name}: stackY")
    _stack(ringU, 3, stackY.dtype, f"{name}: ringU")
    _stack(ringV, 3, stackY.dtype, f"{name}: ringV")
    S, planes, hs, ws = stackY.shape
    if planes != 4 or hs < H + 2 * PAD or ws < W + 2 * PAD or \
            ringU.shape != ringV.shape or ringU.shape[0] != S or \
            ringU.shape[1] < H // 2 + 2 * PAD or \
            ringU.shape[2] < W // 2 + 2 * PAD:
        raise ValueError(f"{name}: stacks {tuple(stackY.shape)}, "
                         f"{tuple(ringU.shape)} and {tuple(ringV.shape)} "
                         f"do not hold the padded {W}x{H} picture's slots")
    _tensor(mv, torch.int32, (N, 2), f"{name}: mv")
    _tensor(slot, torch.int32, (N,), f"{name}: slot")
    _tensor(wp_l, torch.int32, (N, 3), f"{name}: wp_l")
    _tensor(wp_c, torch.int32, (N, 2, 3), f"{name}: wp_c")
    _tensor(res_y, torch.int32, (H, W), f"{name}: res_y", 16)
    _tensor(res_c, torch.int32, (2, H // 2, W // 2), f"{name}: res_c", 16)
    _tensor(inter, torch.bool, (gh, gw), f"{name}: inter")
    total, views = _mc_layout(gw, gh)
    flat = torch.empty(total, dtype=torch.int32, device=device)
    out = tuple(flat[o:o + shape[0] * shape[1]].view(shape)
                for shape, o in views)
    with _on(device):
        rc = kernels.load().hl_mc_dec(
            *(t.data_ptr() for t in (stackY, ringU, ringV)),
            stackY.element_size(),
            *(t.data_ptr() for t in (mv, slot, wp_l, wp_c, res_y, res_c,
                                     inter, *out)),
            hs, ws, ringU.shape[1], ringU.shape[2], gw, gh, _stream(device))
    _check(rc, "hl_mc_dec")
    LAUNCHES["mc_dec"] += 1
    return out


@lru_cache(maxsize=None)
def identity_mc_inputs(gw: int, gh: int, device):
    """MC alone through ``mc_recon_fast``: slot 0, the identity weights,
    a zero residual and every MB inter (the prediction is then the
    output's interior, as ``_weigh`` already clips), made once per grid
    and device: (slot, wp_l, wp_c, res_y, res_c, inter).  Shared: never
    written."""
    n, H, W = gh * gw * 16, gh * 16, gw * 16
    wp = torch.zeros((n, 2, 3), dtype=torch.int32, device=device)
    wp[..., 0] = 1
    return (torch.zeros(n, dtype=torch.int32, device=device),
            wp[:, 0].contiguous(), wp,
            torch.zeros((H, W), dtype=torch.int32, device=device),
            torch.zeros((2, H // 2, W // 2), dtype=torch.int32,
                        device=device),
            torch.ones((gh, gw), dtype=torch.bool, device=device))


def ring_write_plain(y2, u2, v2, ringY, ringU, ringV, ws: int, out, *,
                     gw: int, gh: int):
    """The plain twin of ``ring_write_fast``: slot ws of ringY gets the
    ``halfpel_planes`` stack of ``pad_edge(y2)`` and of ringU / ringV
    ``pad_edge(u2)`` / ``pad_edge(v2)``, as bytes, zeros in the rest of
    the slot; out (H*3/2, W) the picture's bytes, U and V side by side per
    row.  Writes in place and returns out."""
    H, W = gh * 16, gw * 16
    Hp, Wp = H + 2 * PAD, W + 2 * PAD
    Hcp, Wcp = H // 2 + 2 * PAD, W // 2 + 2 * PAD
    uv = torch.stack([u2, v2], dim=1).reshape(H // 2, W)
    out.copy_(torch.cat([y2, uv], dim=0).to(torch.uint8))
    ringY[ws].zero_()
    ringY[ws, :, :Hp, :Wp] = halfpel_planes(pad_edge(y2)).to(torch.uint8)
    for ring, c in ((ringU, u2), (ringV, v2)):
        ring[ws].zero_()
        ring[ws, :Hcp, :Wcp] = pad_edge(c).to(torch.uint8)
    return out


def ring_write_fast(y2, u2, v2, ringY, ringU, ringV, ws: int, out, *,
                    gw: int, gh: int):
    """Write a decoded picture into slot ws of the DPB ring and into its
    output row: y2 (H, W), u2 / v2 (H/2, W/2) the deblocked int32
    interiors (unit column stride, a row stride that is a multiple of 4
    and data 16-byte aligned, as the kernel reads int4; samples in
    0..255);
    ringY (S, 4, Hr, Wr), ringU / ringV (S, Hcr, Wcr) contiguous uint8
    (``d_gop.ring_shapes``: Hr a multiple of 16, Wr of 64); out (H*3/2,
    W) contiguous uint8.  CUDA tensors -> one ``hl_ring_write_dec``
    launch; CPU tensors -> ``ring_write_plain``.  Returns out."""
    name = "ring_write_fast"
    args = (y2, u2, v2, ringY, ringU, ringV, out)
    device = _device(name, args)
    if device is None:
        return ring_write_plain(y2, u2, v2, ringY, ringU, ringV, ws, out,
                                gw=gw, gh=gh)
    from hartallo_tpu_torch import kernels
    H, W = gh * 16, gw * 16
    for p, shape, n in ((y2, (H, W), "y2"), (u2, (H // 2, W // 2), "u2"),
                        (v2, (H // 2, W // 2), "v2")):
        if p.dtype != torch.int32 or tuple(p.shape) != shape or \
                p.stride(1) != 1 or p.stride(0) % 4 or p.data_ptr() % 16:
            raise ValueError(f"{name}: {n} {p.dtype} {tuple(p.shape)} with "
                             f"strides {p.stride()}; it needs int32, "
                             f"{shape}, unit column stride, a row stride "
                             "that is a multiple of 4 and 16-byte aligned "
                             "data")
    _stack(ringY, 4, torch.uint8, f"{name}: ringY")
    _stack(ringU, 3, torch.uint8, f"{name}: ringU")
    _stack(ringV, 3, torch.uint8, f"{name}: ringV")
    S, planes, hr, wr = ringY.shape
    _, hcr, wcr = ringU.shape
    if planes != 4 or hr % 16 or wr % 64 or hr < H + 2 * PAD or \
            wr < W + 2 * PAD or ringV.shape != ringU.shape or \
            ringU.shape[0] != S or wcr % 4 or hcr < H // 2 + 2 * PAD or \
            wcr < W // 2 + 2 * PAD or not 0 <= ws < S:
        raise ValueError(f"{name}: rings {tuple(ringY.shape)}, "
                         f"{tuple(ringU.shape)} and {tuple(ringV.shape)}, "
                         f"slot {ws}, for the padded {W}x{H} picture")
    _tensor(out, torch.uint8, (H * 3 // 2, W), f"{name}: out", 4)
    with _on(device):
        rc = kernels.load().hl_ring_write_dec(
            y2.data_ptr(), u2.data_ptr(), v2.data_ptr(), y2.stride(0),
            u2.stride(0), v2.stride(0), ringY[ws].data_ptr(),
            ringU[ws].data_ptr(), ringV[ws].data_ptr(), out.data_ptr(), hr,
            wr, hcr, wcr, gw, gh, _stream(device))
    _check(rc, "hl_ring_write_dec")
    LAUNCHES["ring_write_dec"] += 1
    return out
