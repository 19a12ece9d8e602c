"""Frame deblock (spec 8.7) as one CUDA kernel launch, and its plain twin.

Counterpart of ``hartallo_tpu/ops/deblock_pallas.py`` (``deblock_frame_pl``,
a drop-in for ``deblock_frame_s1``).  ``deblock_frame_fast`` has the
``deblock_frame_s1`` contract: PAD-padded int32 planes (Y, U, V) in,
new filtered planes out, the inputs untouched.  It gathers the per-MB
parameters with ``ops/deblock.edge_params`` (int16 is lossless: alpha <=
255, beta <= 18, tc0 <= 25, bS <= 4) and launches the row-wavefront
kernel of ``csrc/deblock.cu`` (one warp per MB row, a cooperative
launch) on the planes' current CUDA stream.  On CPU
tensors it runs ``deblock_frame_fast_plain``.  ``deblock_frame_aux_fast``
launches the same kernel on parameters gathered already (the encoder's
in-loop deblock, whose ``csrc/p_encode.cu`` kernel gathers them).  There
is no other branch: a failed build or launch raises.
"""
from __future__ import annotations

import ctypes

import torch

from hartallo_tpu_torch.ops.deblock import PAD, deblock_filter, \
    deblock_frame_s1, edge_params

LAUNCHES = 0         # frames deblocked by the CUDA kernel in this process

# The plain twin: the same wavefront as eager torch ops (``deblock_filter``
# over ``edge_params``), on the tensors' device.
deblock_frame_fast_plain = deblock_frame_s1


def deblock_frame_fast(planes, bs_v, bs_h, qp_y, qp_left, qp_top,
                       qpc_cur, qpc_left, qpc_top, alpha_off, beta_off,
                       *, gw: int, gh: int):
    """Deblock one frame.  bs_v/bs_h (gh, gw, 4, 4) [edge][segment]; the
    QP and offset maps (gh, gw).  CUDA tensors -> the CUDA kernel; CPU
    tensors -> ``deblock_frame_fast_plain``."""
    args = (*planes, bs_v, bs_h, qp_y, qp_left, qp_top, qpc_cur, qpc_left,
            qpc_top, alpha_off, beta_off)
    kinds = {t.device.type for t in args}
    if kinds == {"cpu"}:
        return deblock_frame_fast_plain(
            planes, bs_v, bs_h, qp_y, qp_left, qp_top, qpc_cur, qpc_left,
            qpc_top, alpha_off, beta_off, gw=gw, gh=gh)
    if kinds != {"cuda"}:
        raise ValueError(f"deblock_frame_fast: tensors on {sorted(kinds)}; "
                         "all must be on one CUDA device or all on the CPU")
    aux = edge_params(bs_v, bs_h, qp_y, qp_left, qp_top, qpc_cur, qpc_left,
                      qpc_top, alpha_off, beta_off).to(torch.int16)
    return _launch(aux.contiguous(), planes, gw=gw, gh=gh)


def deblock_frame_aux_plain(planes, aux, *, gw: int, gh: int):
    """The plain twin of ``deblock_frame_aux_fast``: ``deblock_filter`` on
    copies of the planes."""
    return deblock_filter(tuple(p.to(torch.int32).clone() for p in planes),
                          aux, gw=gw, gh=gh)


def deblock_frame_aux_fast(planes, aux, *, gw: int, gh: int):
    """Deblock one frame with its parameters already gathered: ``aux``
    (gh, gw, NAUX), the rows of ``edge_params`` (int16 on a CUDA device:
    ``p_body_fast.deblock_params_fast``'s).  CUDA tensors -> the CUDA
    kernel; CPU tensors -> ``deblock_frame_aux_plain``.  New planes
    out, the inputs untouched."""
    kinds = {t.device.type for t in (*planes, aux)}
    if kinds == {"cpu"}:
        return deblock_frame_aux_plain(planes, aux, gw=gw, gh=gh)
    if kinds != {"cuda"}:
        raise ValueError(f"deblock_frame_aux_fast: tensors on "
                         f"{sorted(kinds)}; all must be on one CUDA device "
                         "or all on the CPU")
    return _launch(aux, planes, gw=gw, gh=gh)


def _launch(aux, planes, *, gw: int, gh: int):
    global LAUNCHES
    from hartallo_tpu_torch import kernels

    dev = planes[0].device
    want = ((gh * 16 + 2 * PAD, gw * 16 + 2 * PAD),
            (gh * 8 + 2 * PAD, gw * 8 + 2 * PAD),
            (gh * 8 + 2 * PAD, gw * 8 + 2 * PAD))
    for name, p, shape in zip("YUV", planes, want):
        if tuple(p.shape) != shape:
            raise ValueError(f"plane {name} has shape {tuple(p.shape)}, "
                             f"expected {shape}")
        if p.device != dev:
            raise ValueError(f"plane {name} is on {p.device}, Y on {dev}")
    if tuple(aux.shape) != (gh, gw, 62) or aux.device != dev or \
            aux.dtype != torch.int16 or not aux.is_contiguous():
        raise ValueError(f"aux {tuple(aux.shape)} {aux.dtype} on "
                         f"{aux.device} is not a contiguous int16 "
                         f"({gh}, {gw}, 62) tensor on {dev}")
    out = tuple(p.to(torch.int32).clone(memory_format=torch.contiguous_format)
                for p in planes)
    prog = torch.zeros(gh, dtype=torch.int32, device=dev)   # row progress
    lib = kernels.load()
    with torch.cuda.device(dev):
        rc = lib.hl_deblock_frame(
            *(ctypes.c_void_p(t.data_ptr()) for t in (aux, *out, prog)), gw,
            gh,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"hl_deblock_frame: CUDA error {rc} "
                           f"({kernels.error_string(rc)})")
    LAUNCHES += 1
    return out
