"""GOP-batched decode through the dense per-MB buffer (torch).

Port of ``hartallo_tpu/decode/d_gop.py``: residual decode and boundary
strengths are computed batched over the K pictures up front, then a
Python loop walks the pictures in decode order with the DPB held as a
ring of reference slots, each slot the four half-pel grids [G, b, h, j]
of one picture plus its padded chroma.  This is the route of the pictures
the whole-GOP kernel (``d_gop_fast``) refuses, as in the JAX package.
On a CUDA device these steps are hand-written kernels, on the CPU their
plain twins: the deblock parameters of the K pictures
(``ops/deblock_fast.deblock_params_dec_fast``, one launch), each
picture's intra wavefront (``decode/intra_recon_fast
.intra_reconstruct_fast``) and deblock (``deblock_frame_aux_fast``; the
JAX package runs the Pallas ``deblock_frame_pl`` here on a TPU), and
the half-pel stack of each reference it writes
(``encode/p_body_fast.halfpel_planes_fast``).  The batched work
(``prepare_pictures``) and the per-picture body
(``reconstruct_picture``) are also the band body of the sharded decode,
``parallel/shard.decode_frame_step_sharded``.

Reference counterpart: the per-picture decode driver
``hl_codec_264_decode_avc.c:55-263``.
"""
from __future__ import annotations

import numpy as np
import torch

from hartallo_tpu_torch.core.tables import QP_SCALE_CHROMA
from hartallo_tpu_torch.decode.d_fused import DEC_FIELDS
from hartallo_tpu_torch.decode.intra_recon import PAD
from hartallo_tpu_torch.decode.intra_recon_fast import intra_reconstruct_fast
from hartallo_tpu_torch.encode.p_body_fast import halfpel_planes_fast
from hartallo_tpu_torch.ops.deblock_fast import (deblock_frame_aux_fast,
                                                 deblock_params_dec_fast,
                                                 record_offsets)
from hartallo_tpu_torch.ops.wide import (mc_chroma_plane, mc_grids,
                                         mc_luma_plane, pad_edge,
                                         residual_planes_wide)

_OFF = {}
_o = 0
for _name, _shape in DEC_FIELDS:
    _w = int(np.prod(_shape, dtype=int)) if _shape else 1
    _OFF[_name] = (_o, _o + _w, _shape)
    _o += _w
WORDS = _o
# the deblock parameters' fields in the dense buffer
DEBLOCK_OFFSETS = record_offsets(DEC_FIELDS)[0]


def _field(packed, name, gw, gh):
    """packed (K, Nmb, WORDS) -> (K, gh, gw) + field shape."""
    o0, o1, shape = _OFF[name]
    return packed[:, :, o0:o1].reshape((packed.shape[0], gh, gw) + shape)


def ring_shapes(gw: int, gh: int, S: int):
    """DPB ring shapes (S slots), over-allocated like the JAX package's
    (+32 rows, width rounded up to 128 plus 128) so that rings compare
    like for like; only [:Hp, :Wp] / [:Hcp, :Wcp] of a slot is read."""
    Hp, Wp = gh * 16 + 2 * PAD, gw * 16 + 2 * PAD
    Hc, Wc = gh * 8 + 2 * PAD, gw * 8 + 2 * PAD

    def rnd(n):
        return ((n + 127) // 128) * 128 + 128

    return ((S, 4, Hp + 32, rnd(Wp)), (S, Hc + 32, rnd(Wc)),
            (S, Hc + 32, rnd(Wc)))


def decode_gop(packed, write_slot, has_intra, ringY, ringU, ringV,
               *, gw: int, gh: int, chroma_qp_off: int):
    """Decode K pictures from their dense buffers.

    packed (K, gh*gw, WORDS) int16 (``d_fused.pack_slice_arrays``);
    write_slot (K,) ring slot of each recon (the last slot is the
    non-reference trash slot); has_intra (K,) bool; ringY (S, 4, Hr, Wr),
    ringU/ringV (S, Hcr, Wcr) uint8 on the decoder's device.

    The ring is state: it is updated IN PLACE, picture by picture (slot
    write_slot[k] after picture k), and returned.  Returns (out (K,
    H*3//2, W) uint8 with U and V side by side per row, ringY, ringU,
    ringV)."""
    dev = ringY.device
    packed = torch.as_tensor(np.asarray(packed), device=dev).to(torch.int32)
    write_slot = [int(s) for s in np.asarray(write_slot)]
    has_intra = [bool(h) for h in np.asarray(has_intra)]
    H, W = gh * 16, gw * 16
    batch = prepare_pictures(packed, gw=gw, gh=gh,
                             chroma_qp_off=chroma_qp_off)
    outs = []
    Hp, Wp = H + 2 * PAD, W + 2 * PAD
    Hcp, Wcp = H // 2 + 2 * PAD, W // 2 + 2 * PAD
    for k in range(packed.shape[0]):
        y2, u2, v2 = reconstruct_picture(batch, k, ringY, ringU, ringV,
                                         has_intra[k], gw=gw, gh=gh)
        uv = torch.stack([u2, v2], dim=1).reshape(H // 2, W)
        outs.append(torch.cat([y2, uv], dim=0).to(torch.uint8))

        ws = write_slot[k]
        ringY[ws].zero_()
        ringY[ws, :, :Hp, :Wp] = halfpel_planes_fast(pad_edge(y2)) \
            .to(torch.uint8)
        for ring, c in ((ringU, u2), (ringV, v2)):
            ring[ws].zero_()
            ring[ws, :Hcp, :Wcp] = pad_edge(c).to(torch.uint8)
    return torch.stack(outs), ringY, ringU, ringV


def prepare_pictures(packed, *, gw: int, gh: int, chroma_qp_off: int):
    """The work of K pictures that needs no reference: residual planes,
    deblock parameters and the MC and intra inputs, batched over the
    pictures.  packed (K, gh*gw, WORDS) int32 on the device, contiguous;
    returns a dict that ``reconstruct_picture`` reads."""
    dev = packed.device
    K = packed.shape[0]
    M = K * gh * gw
    N = gh * gw * 16
    qpc_table = torch.as_tensor(QP_SCALE_CHROMA, dtype=torch.int32,
                                device=dev)

    def fld(name):
        return _field(packed, name, gw, gh)

    def sl(name):
        return packed[:, :, slice(*_OFF[name][:2])]

    qp, kind = fld("qp"), fld("kind")
    res_y, res_c = residual_planes_wide(
        sl("luma_ac").reshape(M, 16, 16), sl("luma_dc").reshape(M, 16),
        sl("chroma_ac").reshape(M, 2, 4, 16), sl("chroma_dc").reshape(M, 2, 4),
        qp.reshape(M), (kind == 1).reshape(M), chroma_qp_off, qpc_table,
        gw, gh)

    mv = fld("mv")                                     # (K,gh,gw,4,4,2)
    ref44 = fld("ref_idx").reshape(K, gh, gw, 2, 2) \
        .repeat_interleave(2, 3).repeat_interleave(2, 4)
    inter_mask = (kind >= 3) & (kind != 8)
    return {
        "res_y": res_y, "res_c": res_c,
        "aux": deblock_params_dec_fast(packed, DEBLOCK_OFFSETS,
                                       chroma_qp_off, gw=gw, gh=gh),
        "grids": mc_grids(gw, gh, dev),
        "mask_y": inter_mask.repeat_interleave(16, -2)
        .repeat_interleave(16, -1),
        "mask_c": inter_mask.repeat_interleave(8, -2)
        .repeat_interleave(8, -1),
        "wp_l": fld("wp_l").reshape(K, gh, gw, 2, 2, 3)
        .repeat_interleave(2, 3).repeat_interleave(2, 4).reshape(K, N, 3),
        "wp_c": fld("wp_c").reshape(K, gh, gw, 2, 2, 2, 3)
        .repeat_interleave(2, 3).repeat_interleave(2, 4)
        .reshape(K, N, 2, 3),
        "mv": mv.reshape(K, N, 2), "slot": ref44.reshape(K, N),
        **{name: fld(name) for name in ("kind", "i16_mode", "i4_modes",
                                        "chroma_mode")},
        **{name: fld(name) != 0 for name in ("avail_l", "avail_t",
                                             "avail_tr")},
    }


def reconstruct_picture(batch, k, stackY, ringU, ringV, has_intra: bool,
                        *, gw: int, gh: int):
    """Picture k of a ``prepare_pictures`` batch: MC from the reference
    slots, residual add, the intra wavefront when ``has_intra``
    (``intra_reconstruct_fast``), and the frame deblock on the batch's
    parameters (``deblock_frame_aux_fast``).  stackY (S, 4, Hr, Wr) holds
    each slot's [G, b, h, j] planes, ringU/ringV (S, Hcr, Wcr) the padded
    chroma (either may be over-allocated, uint8 or int32).  Returns the
    (H, W), (H/2, W/2), (H/2, W/2) int32 planes."""
    b = batch
    H, W = gh * 16, gw * 16
    dev = stackY.device
    bx, by, cbx, cby = b["grids"]
    mvf, slot = b["mv"][k], b["slot"][k]
    ry, rc = b["res_y"][k], b["res_c"][k]
    pY = mc_luma_plane(stackY, slot, bx, by, mvf[:, 0], mvf[:, 1],
                       b["wp_l"][k], gw, gh)
    pU = mc_chroma_plane(ringU, slot, cbx, cby, mvf[:, 0], mvf[:, 1],
                         b["wp_c"][k][:, 0], gw, gh)
    pV = mc_chroma_plane(ringV, slot, cbx, cby, mvf[:, 0], mvf[:, 1],
                         b["wp_c"][k][:, 1], gw, gh)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    planes = tuple(
        torch.nn.functional.pad(
            torch.where(msk, torch.clamp(p + r, 0, 255), zero),
            (PAD, PAD, PAD, PAD))
        for p, r, msk in ((pY, ry, b["mask_y"][k]),
                          (pU, rc[0], b["mask_c"][k]),
                          (pV, rc[1], b["mask_c"][k])))
    if has_intra:
        planes = intra_reconstruct_fast(
            planes, ry.reshape(gh, 16, gw, 16).permute(0, 2, 1, 3),
            rc.reshape(2, gh, 8, gw, 8).permute(1, 3, 0, 2, 4),
            *(b[name][k] for name in ("kind", "i16_mode", "i4_modes",
                                      "chroma_mode", "avail_l", "avail_t",
                                      "avail_tr")), gw=gw, gh=gh)
    y2p, u2p, v2p = deblock_frame_aux_fast(planes, b["aux"][k], gw=gw,
                                           gh=gh)
    return (y2p[PAD:PAD + H, PAD:PAD + W],
            u2p[PAD:PAD + H // 2, PAD:PAD + W // 2],
            v2p[PAD:PAD + H // 2, PAD:PAD + W // 2])


def split_gop_out(a: np.ndarray, gw: int, gh: int) -> np.ndarray:
    """Host: one (H*3//2, W) uint8 row of the batch -> packed I420."""
    H, W = gh * 16, gw * 16
    y = a[:H]
    uv = a[H:].reshape(H // 2, 2, W // 2)
    return np.concatenate([y.ravel(), uv[:, 0].ravel(), uv[:, 1].ravel()])
