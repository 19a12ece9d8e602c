"""Whole-frame encode programs (torch): mode decision / ME, transform and
quant, recon and the in-loop deblock of one picture, with every host-bound
per-MB array packed into one int16 buffer (one device-to-host copy per
picture).

Port of ``hartallo_tpu/encode/e_device.py``.  The intra wavefront is
``encode/intra_encode_fast.intra_encode_frame_fast``, the P picture's
search, residual and intra-in-P mask ``p_device.p_frame_with_mask``, and
the in-loop deblock ``encode/p_body_fast.deblock_params_fast`` (bS and
thresholds) then ``ops/deblock_fast.deblock_frame_aux_fast`` (the
filter): each a CUDA kernel on a CUDA device, its plain twin on the
CPU.  What stays eager here is the source split, the intra merge, the
repad, the pack and the MAD.  ``p_gop_fused``'s ``lax.scan`` is a Python
loop over the pictures, and the intra-in-P ``lax.cond`` is a Python
``if`` on the device's answer (a host sync per P picture).
Reference counterpart: the per-slice encode loop
``hl_codec_264_slice.c:1700-1930`` and the deblock at completion
(``:1897-1903``).
"""
from __future__ import annotations

import numpy as np
import torch

from hartallo_tpu_torch.decode.intra_recon import PAD
from hartallo_tpu_torch.encode.intra_encode import qpc_of
from hartallo_tpu_torch.encode.intra_encode_fast import \
    intra_encode_frame_fast
from hartallo_tpu_torch.encode.p_body_fast import deblock_params_fast
from hartallo_tpu_torch.encode.p_device import p_frame_with_mask
from hartallo_tpu_torch.ops.deblock import compute_bs, edge_params
from hartallo_tpu_torch.ops.deblock_fast import (deblock_frame_aux_fast,
                                                 deblock_frame_fast)
from hartallo_tpu_torch.ops.wide import _RASTER_TO_BLK, pad_edge

# packed-buffer layout: name -> per-MB trailing shape
INTRA_FIELDS = [
    ("use_i16", ()), ("i16_mode", ()), ("i4_modes", (16,)),
    ("chroma_mode", ()), ("luma_dc", (4, 4)), ("luma_ac", (16, 4, 4)),
    ("chroma_dc", (2, 2, 2)), ("chroma_ac", (2, 4, 4, 4)),
]
P_FIELDS = [
    ("luma_ac", (16, 4, 4)), ("chroma_dc", (2, 2, 2)),
    ("chroma_ac", (2, 4, 4, 4)), ("mv44", (4, 4, 2)), ("choice", ()),
    # intra-in-P (hl_codec_264_slice.c:1797: the reference picks intra vs
    # inter per macroblock)
    ("is_intra", ()), ("use_i16", ()), ("i16_mode", ()),
    ("i4_modes", (16,)), ("chroma_mode", ()), ("luma_dc", (4, 4)),
]


def _pack(arrays, fields, gh: int, gw: int) -> torch.Tensor:
    """Stack per-MB arrays into one (gh*gw, n_words) int16 transfer
    buffer (lossless: spec A.2.1 bounds coefficients to +-2^15)."""
    return torch.cat([arrays[name].to(torch.int16).reshape(
        gh * gw, int(np.prod(shape, dtype=int)) if shape else 1)
        for name, shape in fields], dim=1)


def unpack(buf, fields, gh: int, gw: int):
    """Inverse of _pack on the host (numpy)."""
    out = {}
    off = 0
    for name, shape in fields:
        n = int(np.prod(shape, dtype=int)) if shape else 1
        out[name] = buf[:, off:off + n].reshape((gh, gw) + shape)
        off += n
    return out


def _interior(p: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return p[PAD:PAD + h, PAD:PAD + w]


def _mad(srcY, recY, H: int, W: int) -> torch.Tensor:
    return (_interior(srcY, H, W) - _interior(recY, H, W)).abs() \
        .sum(dtype=torch.int32)


def _shift_map(a: torch.Tensor, dim: int) -> torch.Tensor:
    """The left (dim 1) or top (dim 0) neighbour's value, the edge MB its
    own."""
    first = a.narrow(dim, 0, 1)
    return torch.cat([first, a.narrow(dim, 0, a.shape[dim] - 1)], dim=dim)


def _edge_flags(fmb_v, fmb_h, gw: int, gh: int, dev):
    """The MB edge flags as bool tensors on ``dev``; None is every MB edge
    inside the picture."""
    if fmb_v is None:
        fmb_v = torch.zeros((gh, gw), dtype=torch.bool, device=dev)
        fmb_v[:, 1:] = True
    if fmb_h is None:
        fmb_h = torch.zeros((gh, gw), dtype=torch.bool, device=dev)
        fmb_h[1:, :] = True
    return torch.as_tensor(fmb_v, device=dev), \
        torch.as_tensor(fmb_h, device=dev)


def _qp_maps(qp, chroma_qp_off: int):
    """The QP maps of ``deblock_frame_fast`` / ``edge_params``: the MB's,
    its left and top neighbours' (the edge MB its own), and the same of
    the chroma QP."""
    qpc = qpc_of(qp, chroma_qp_off)
    return (qp, _shift_map(qp, 1), _shift_map(qp, 0), qpc,
            _shift_map(qpc, 1), _shift_map(qpc, 0))


def deblock_grids(planes, mb_is_intra, nnz, mvg, refg, qp, chroma_qp_off,
                  gw: int, gh: int, fmb_v=None, fmb_h=None, fint=None,
                  alpha_off=None, beta_off=None):
    """One frame deblock through ``deblock_frame_fast`` from per-4x4
    grids, on the device: the decoder's general route.

    nnz (4gh,4gw) luma TotalCoeff; mvg (4gh,4gw,2) quarter-pel MVs; refg
    (4gh,4gw) refIdx; mb_is_intra, fmb_v, fmb_h, fint (gh,gw) bool (the
    edge flags default to every MB edge inside the picture and every
    internal edge); qp and the alpha/beta offsets (gh,gw) int32 (the
    offsets default to 0); planes PAD-padded int32.  Returns the new
    planes."""
    dev = qp.device
    if fint is None:
        fint = torch.ones((gh, gw), dtype=torch.bool, device=dev)
    bs_v, bs_h = compute_bs(mb_is_intra, nnz, mvg, refg,
                            *_edge_flags(fmb_v, fmb_h, gw, gh, dev), fint)
    zeros = torch.zeros((gh, gw), dtype=torch.int32, device=dev)
    return deblock_frame_fast(
        planes, bs_v, bs_h, *_qp_maps(qp, chroma_qp_off),
        zeros if alpha_off is None else alpha_off,
        zeros if beta_off is None else beta_off, gw=gw, gh=gh)


def deblock_params(wq, mv44, ref44, mb_is_intra, qp, chroma_qp_off,
                   fmb_v=None, fmb_h=None, *, gw: int, gh: int):
    """The in-loop deblock's per-MB parameters of a coded picture: the
    luma TotalCoeff of its 4x4 blocks, ``compute_bs`` and ``edge_params``
    (slice offsets 0), as (gh, gw, NAUX) int16 rows.  The plain twin of
    ``p_body_fast.deblock_params_fast``; arguments as
    ``deblock_recon_device``'s."""
    dev = wq.device
    counts = (wq != 0).sum(dim=(-1, -2)).to(torch.int32)    # (gh,gw,16)
    nnz = counts[:, :, torch.as_tensor(_RASTER_TO_BLK, device=dev)] \
        .reshape(gh, gw, 4, 4).permute(0, 2, 1, 3).reshape(4 * gh, 4 * gw)
    mvg = mv44.permute(0, 2, 1, 3, 4).reshape(4 * gh, 4 * gw, 2)
    refg = ref44.permute(0, 2, 1, 3).reshape(4 * gh, 4 * gw)
    bs_v, bs_h = compute_bs(mb_is_intra, nnz, mvg, refg,
                            *_edge_flags(fmb_v, fmb_h, gw, gh, dev),
                            torch.ones((gh, gw), dtype=torch.bool,
                                       device=dev))
    zeros = torch.zeros((gh, gw), dtype=torch.int32, device=dev)
    return edge_params(bs_v, bs_h, *_qp_maps(qp, chroma_qp_off), zeros,
                       zeros).to(torch.int16)


def deblock_recon_device(wq, mv44, ref44, mb_is_intra, qp, chroma_qp_off,
                         planes, gw: int, gh: int, fmb_v=None, fmb_h=None):
    """In-loop deblock of the encoder recon, on the device: the parameters
    (``deblock_params_fast``), then the filter (``deblock_frame_aux_fast``),
    a kernel each on a CUDA device.

    wq (gh,gw,16,4,4) quantized luma AC (blkIdx order); mv44
    (gh,gw,4,4,2) quarter-pel MVs; ref44 (gh,gw,4,4) per-4x4 refIdx;
    mb_is_intra (gh,gw) bool; qp (gh,gw) int32; planes PAD-padded int32.
    Returns the new planes."""
    aux = deblock_params_fast(
        wq, mv44, ref44, mb_is_intra.to(torch.bool),
        qp.to(torch.int32).contiguous(), chroma_qp_off, fmb_v, fmb_h,
        gw=gw, gh=gh)
    return deblock_frame_aux_fast(planes, aux, gw=gw, gh=gh)


def _split_src(src_u8, gw: int, gh: int):
    """(H*3//2, W) uint8 I420 -> edge-padded int32 planes."""
    H, W = gh * 16, gw * 16
    y = src_u8[:H, :].to(torch.int32)
    uv = src_u8[H:, :].reshape(H // 2, 2, W // 2).to(torch.int32)
    return pad_edge(y), pad_edge(uv[:, 0, :]), pad_edge(uv[:, 1, :])


def pack_src(frame: np.ndarray, width: int, height: int,
             gw: int, gh: int) -> np.ndarray:
    """Host: raw I420 buffer -> the (H*3//2, W) uint8 layout _split_src
    expects (U rows and V rows interleaved per row pair), padded to the
    MB grid by edge replication."""
    H, W = gh * 16, gw * 16
    buf = np.frombuffer(bytes(frame), np.uint8) if not \
        isinstance(frame, np.ndarray) else frame.ravel()
    ysz = width * height
    y = buf[:ysz].reshape(height, width)
    u = buf[ysz:ysz + ysz // 4].reshape(height // 2, width // 2)
    v = buf[ysz + ysz // 4:ysz + ysz // 2].reshape(height // 2, width // 2)
    y = np.pad(y, ((0, H - height), (0, W - width)), mode="edge")
    u = np.pad(u, ((0, (H - height) // 2), (0, (W - width) // 2)),
               mode="edge")
    v = np.pad(v, ((0, (H - height) // 2), (0, (W - width) // 2)),
               mode="edge")
    uv = np.stack([u, v], axis=1)
    return np.concatenate([y, uv.reshape(H // 2, W)], axis=0)


def i_frame_fused(src_u8, qp, lam, avail_l, avail_t, avail_tr, avail_tl,
                  fmb_v, fmb_h, *, gw: int, gh: int, chroma_qp_off: int,
                  deblock: bool):
    """IDR frame: intra wavefront encode + in-loop deblock + packed output.
    Returns (packed (gh*gw, n) int16, mad_sum, recY, recU, recV)."""
    dev = src_u8.device
    H, W = gh * 16, gw * 16
    qp = torch.as_tensor(qp, device=dev).to(torch.int32)
    srcY, srcU, srcV = _split_src(src_u8, gw, gh)
    recY, recU, recV, arrays = intra_encode_frame_fast(
        srcY, srcU, srcV, qp, chroma_qp_off, avail_l, avail_t, lam,
        avail_tr, avail_tl, gw=gw, gh=gh)
    if deblock:
        recY, recU, recV = deblock_recon_device(
            arrays["luma_ac"],
            torch.zeros((gh, gw, 4, 4, 2), dtype=torch.int32, device=dev),
            torch.zeros((gh, gw, 4, 4), dtype=torch.int32, device=dev),
            torch.ones((gh, gw), dtype=torch.bool, device=dev), qp,
            chroma_qp_off, (recY, recU, recV), gw, gh, fmb_v=fmb_v,
            fmb_h=fmb_h)
    packed = _pack(arrays, INTRA_FIELDS, gh, gw)
    return packed, _mad(srcY, recY, H, W), recY, recU, recV


def _p_frame_body(src_u8, refY, refU, refV, qp, lam, fmb_v, fmb_h,
                  avail_l=None, avail_t=None, avail_tr=None, avail_tl=None,
                  *, gw: int, gh: int, rng: int, refine: bool,
                  chroma_qp_off: int, deblock: bool,
                  intra_in_p: bool = True):
    dev = src_u8.device
    H, W = gh * 16, gw * 16
    lam = torch.as_tensor(lam, dtype=torch.float32, device=dev)
    qp = torch.as_tensor(qp, device=dev).to(torch.int32)
    srcY, srcU, srcV = _split_src(src_u8, gw, gh)
    (wq, dcq, acq, mv44, choice, recY, recU, recV, _), mask = \
        p_frame_with_mask(srcY, srcU, srcV, refY, refU, refV, qp, lam,
                          gw=gw, gh=gh, rng=rng, refine=refine,
                          chroma_qp_off=chroma_qp_off, intra_in_p=intra_in_p)

    z = torch.zeros((gh, gw), dtype=torch.int32, device=dev)
    use16, i16m, cmode = z, z, z
    i4m = torch.zeros((gh, gw, 16), dtype=torch.int32, device=dev)
    ldc = torch.zeros((gh, gw, 4, 4), dtype=torch.int32, device=dev)
    imask = torch.zeros((gh, gw), dtype=torch.bool, device=dev)
    if intra_in_p:
        # ---- intra-in-P: per-MB intra vs inter (hl_codec_264_slice.c:1797),
        # the mask from the residual's kernel (p_device.intra_in_p_mask)
        imask = mask
        if avail_l is None:
            avail_l = torch.zeros((gh, gw), dtype=torch.bool, device=dev)
            avail_l[:, 1:] = True
            avail_t = torch.zeros((gh, gw), dtype=torch.bool, device=dev)
            avail_t[1:, :] = True
            avail_tr = torch.zeros((gh, gw), dtype=torch.bool, device=dev)
            avail_tr[1:, :-1] = True
            avail_tl = torch.zeros((gh, gw), dtype=torch.bool, device=dev)
            avail_tl[1:, 1:] = True
        if bool(imask.any()):                       # host sync
            recY, recU, recV, ia = intra_encode_frame_fast(
                srcY, srcU, srcV, qp, chroma_qp_off, avail_l, avail_t, lam,
                avail_tr, avail_tl, base_planes=(recY, recU, recV),
                mb_mask=imask, gw=gw, gh=gh)
            use16, i16m, i4m = ia["use_i16"], ia["i16_mode"], ia["i4_modes"]
            cmode, ldc = ia["chroma_mode"], ia["luma_dc"]
            m = imask[:, :, None, None, None]
            wq = torch.where(m, ia["luma_ac"], wq)
            dcq = torch.where(m, ia["chroma_dc"], dcq)
            acq = torch.where(m[..., None], ia["chroma_ac"], acq)
            mv44 = torch.where(m, 0, mv44)

    if deblock:
        recY, recU, recV = deblock_recon_device(
            wq, mv44, torch.zeros((gh, gw, 4, 4), dtype=torch.int32,
                                  device=dev),
            imask, qp, chroma_qp_off, (recY, recU, recV), gw, gh,
            fmb_v=fmb_v, fmb_h=fmb_h)
    # re-replicate the pad from the deblocked interior: deblocking can
    # change frame-edge pixels (internal V/H edges), and the decoder's
    # reference ring edge-pads AFTER deblocking
    recY = pad_edge(_interior(recY, H, W))
    recU = pad_edge(_interior(recU, H // 2, W // 2))
    recV = pad_edge(_interior(recV, H // 2, W // 2))
    arrays = {"luma_ac": wq, "chroma_dc": dcq, "chroma_ac": acq,
              "mv44": mv44, "choice": choice.reshape(gh, gw),
              "is_intra": imask.to(torch.int32), "use_i16": use16,
              "i16_mode": i16m, "i4_modes": i4m, "chroma_mode": cmode,
              "luma_dc": ldc}
    packed = _pack(arrays, P_FIELDS, gh, gw)
    return packed, _mad(srcY, recY, H, W), recY, recU, recV


def p_frame_fused(src_u8, refY, refU, refV, qp, lam, fmb_v, fmb_h,
                  avail_l=None, avail_t=None, avail_tr=None, avail_tl=None,
                  *, gw: int, gh: int, rng: int, refine: bool,
                  chroma_qp_off: int, deblock: bool,
                  intra_in_p: bool = True):
    """P frame: ME/MC/transform/recon + in-loop deblock + packed output.
    Returns (packed, mad_sum, recY, recU, recV)."""
    return _p_frame_body(src_u8, refY, refU, refV, qp, lam, fmb_v, fmb_h,
                         avail_l, avail_t, avail_tr, avail_tl,
                         gw=gw, gh=gh, rng=rng, refine=refine,
                         chroma_qp_off=chroma_qp_off, deblock=deblock,
                         intra_in_p=intra_in_p)


def p_gop_fused(src_k_u8, refY, refU, refV, qp_k, lam_k, fmb_v, fmb_h,
                is_ref_k, avail_l=None, avail_t=None, avail_tr=None,
                avail_tl=None, *, gw: int, gh: int, rng: int, refine: bool,
                chroma_qp_off: int, deblock: bool, intra_in_p: bool = True):
    """K consecutive P frames, the recon carried on the device from one
    to the next.  src_k_u8 (K, H*3//2, W) uint8; qp_k (K, gh, gw); lam_k
    (K,) f32; is_ref_k (K,) bool, False for droppable temporal_id > 0
    frames, which leave the carry alone.  Returns (packed (K, gh*gw, n),
    mad (K,), recY, recU, recV)."""
    packed_k, mad_k = [], []
    for k, is_ref in enumerate(np.asarray(is_ref_k, bool).tolist()):
        packed, mad, recY, recU, recV = _p_frame_body(
            src_k_u8[k], refY, refU, refV, qp_k[k], lam_k[k], fmb_v, fmb_h,
            avail_l, avail_t, avail_tr, avail_tl, gw=gw, gh=gh, rng=rng,
            refine=refine, chroma_qp_off=chroma_qp_off, deblock=deblock,
            intra_in_p=intra_in_p)
        if is_ref:
            refY, refU, refV = recY, recU, recV
        packed_k.append(packed)
        mad_k.append(mad)
    return torch.stack(packed_k), torch.stack(mad_k), refY, refU, refV


def ref_planes_from_numpy(planes, device):
    """The JAX encoder's ``_ref_planes`` (PAD-padded int32 arrays, or any
    array-likes) -> the port's int32 tensors on ``device``, copied."""
    return tuple(torch.tensor(np.asarray(p), dtype=torch.int32,
                              device=device) for p in planes)

