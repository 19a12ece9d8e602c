"""GOP-batched decode through the dense per-MB buffer (torch).

Port of ``hartallo_tpu/decode/d_gop.py``: residual decode and boundary
strengths are computed batched over the K pictures up front, then a
Python loop walks the pictures in decode order with the DPB held as a
ring of reference slots, each slot the four half-pel grids [G, b, h, j]
of one picture plus its padded chroma.  This is the route of the pictures
the whole-GOP kernel (``d_gop_fast``) refuses, as in the JAX package.
On a CUDA device every step is a hand-written kernel, on the CPU its
plain twin: the residual planes of the K pictures
(``decode/mc_decode_fast.residual_planes_fast``) and their deblock
parameters (``ops/deblock_fast.deblock_params_dec_fast``), one launch
each; then for each picture the MC with the residual
(``mc_recon_fast``), the intra wavefront (``decode/intra_recon_fast
.intra_reconstruct_fast``), the deblock (``deblock_frame_aux_fast``; the
JAX package runs the Pallas ``deblock_frame_pl`` here on a TPU) and the
ring write of its half-pel stack, chroma and output row
(``ring_write_fast``).  The batched work (``prepare_pictures``) and the
per-picture body (``reconstruct_picture``) are also the band body of the
sharded decode, ``parallel/shard.decode_frame_step_sharded``.

Reference counterpart: the per-picture decode driver
``hl_codec_264_decode_avc.c:55-263``.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from hartallo_tpu_torch.decode.d_fused import DEC_FIELDS
from hartallo_tpu_torch.decode.intra_recon import PAD
from hartallo_tpu_torch.decode.intra_recon_fast import intra_reconstruct_fast
from hartallo_tpu_torch.decode.mc_decode_fast import (RESIDUAL_FIELDS,
                                                      mc_recon_fast,
                                                      residual_planes_fast,
                                                      ring_write_fast)
from hartallo_tpu_torch.ops.deblock_fast import (deblock_frame_aux_fast,
                                                 deblock_params_dec_fast,
                                                 record_offsets)

_OFF = {}
_o = 0
for _name, _shape in DEC_FIELDS:
    _w = int(np.prod(_shape, dtype=int)) if _shape else 1
    _OFF[_name] = (_o, _o + _w, _shape)
    _o += _w
WORDS = _o
# the fields the MC and intra kernels read as int32, one span of the
# record (with nnz, the deblock offsets and flags between them), widened
# by one cast a batch; the levels before it stay int16
_WIDE = ("kind", "i16_mode", "i4_modes", "chroma_mode", "mv", "ref_idx",
         "wp_l", "wp_c")
_W0, _W1 = min(_OFF[n][0] for n in _WIDE), max(_OFF[n][1] for n in _WIDE)
# the deblock parameters' and the residual's fields in the dense buffer
DEBLOCK_OFFSETS = record_offsets(DEC_FIELDS)[0]
RESIDUAL_OFFSETS = record_offsets(DEC_FIELDS, RESIDUAL_FIELDS)[0]
# the 8x8 quadrant of each 4x4 block of an MB, raster order
_QUAD = np.array([(by >> 1) * 2 + (bx >> 1) for by in range(4)
                  for bx in range(4)])


def _field(packed, name, gw, gh):
    """packed (K, Nmb, WORDS) -> (K, gh, gw) + field shape (a view)."""
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

    packed (K, gh*gw, WORDS) int16 (``d_fused.pack_slice_arrays``' rows),
    as it is: on a CUDA decoder a tensor on the rings' device, uploaded
    once (``decode/staging.py``); an int16 array or host tensor is copied
    there; write_slot (K,) ring slot of each recon (the last slot is the
    non-reference trash slot); has_intra (K,) bool; ringY (S, 4, Hr,
    Wr), ringU/ringV (S, Hcr, Wcr) uint8 on the decoder's device.

    The ring is state: it is updated IN PLACE, picture by picture (slot
    write_slot[k] after picture k), and returned.  Returns (out (K,
    H*3//2, W) uint8 with U and V side by side per row, ringY, ringU,
    ringV)."""
    dev = ringY.device
    packed = torch.as_tensor(packed, device=dev)
    if packed.dtype != torch.int16:
        raise ValueError(f"decode_gop: packed is {packed.dtype}; the "
                         "records are int16")
    write_slot = [int(s) for s in np.asarray(write_slot)]
    has_intra = [bool(h) for h in np.asarray(has_intra)]
    K, H, W = packed.shape[0], gh * 16, gw * 16
    batch = prepare_pictures(packed, gw=gw, gh=gh,
                             chroma_qp_off=chroma_qp_off)
    out = torch.empty((K, H * 3 // 2, W), dtype=torch.uint8, device=dev)
    for k in range(K):
        y2, u2, v2 = reconstruct_picture(batch, k, ringY, ringU, ringV,
                                         has_intra[k], gw=gw, gh=gh)
        ring_write_fast(y2, u2, v2, ringY, ringU, ringV, write_slot[k],
                        out[k], gw=gw, gh=gh)
    return out, ringY, ringU, ringV


def prepare_pictures(packed, *, gw: int, gh: int, chroma_qp_off: int):
    """The work of K pictures that needs no reference: residual planes,
    deblock parameters and the MC and intra inputs, batched over the
    pictures.  packed (K, gh*gw, WORDS) int16 on the device, contiguous,
    read as it is by the residual and parameter kernels; only the span of
    fields that the MC and intra kernels read as int32 is widened.
    Returns a dict that ``reconstruct_picture`` reads: per picture the
    residual planes, the deblock rows, the per-4x4-block MVs, slots and
    weights (each 8x8 quadrant's spread to its four blocks, contiguous),
    the inter mask and the intra maps."""
    dev = packed.device
    K = packed.shape[0]
    N = gh * gw * 16

    def fld(name):
        return _field(packed, name, gw, gh)
    widened = packed[:, :, _W0:_W1].to(torch.int32)

    def wide(name):
        o0, o1, shape = _OFF[name]
        return widened[:, :, o0 - _W0:o1 - _W0].reshape((K, gh, gw) + shape)

    kind = wide("kind")
    res_y, res_c = residual_planes_fast(packed, RESIDUAL_OFFSETS,
                                        chroma_qp_off, gw=gw, gh=gh)
    quad = _quad(dev)
    return {
        "res_y": res_y, "res_c": res_c,
        "aux": deblock_params_dec_fast(packed, DEBLOCK_OFFSETS,
                                       chroma_qp_off, gw=gw, gh=gh),
        "mv": wide("mv").reshape(K, N, 2),
        "slot": wide("ref_idx")[..., quad].reshape(K, N),
        "wp_l": wide("wp_l").reshape(K, gh, gw, 4, 3)[:, :, :, quad]
        .reshape(K, N, 3),
        "wp_c": wide("wp_c").reshape(K, gh, gw, 4, 2, 3)[:, :, :, quad]
        .reshape(K, N, 2, 3),
        "inter": (kind >= 3) & (kind != 8),
        "kind": kind,
        **{name: wide(name) for name in ("i16_mode", "i4_modes",
                                         "chroma_mode")},
        **{name: fld(name) != 0 for name in ("avail_l", "avail_t",
                                             "avail_tr")},
    }


@lru_cache(maxsize=None)
def _quad(device) -> torch.Tensor:
    """``_QUAD`` on ``device``, made once per device.  Shared: never
    written."""
    return torch.as_tensor(_QUAD, device=device)


def reconstruct_picture(batch, k, stackY, ringU, ringV, has_intra: bool,
                        *, gw: int, gh: int):
    """Picture k of a ``prepare_pictures`` batch: MC from the reference
    slots with the residual added (``mc_recon_fast``), the intra
    wavefront when ``has_intra`` (``intra_reconstruct_fast``), and the
    frame deblock on the batch's parameters (``deblock_frame_aux_fast``).
    stackY (S, 4, Hr, Wr) holds each slot's [G, b, h, j] planes,
    ringU/ringV (S, Hcr, Wcr) the padded chroma (either may be
    over-allocated; uint8 or int32, both the same).  Returns the (H, W),
    (H/2, W/2), (H/2, W/2) int32 interiors of the deblocked padded
    planes."""
    b = batch
    H, W = gh * 16, gw * 16
    ry, rc = b["res_y"][k], b["res_c"][k]
    planes = mc_recon_fast(stackY, ringU, ringV, b["mv"][k], b["slot"][k],
                           b["wp_l"][k], b["wp_c"][k], ry, rc,
                           b["inter"][k], gw=gw, gh=gh)
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
