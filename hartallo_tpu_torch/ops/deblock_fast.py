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
in-loop deblock, whose ``csrc/p_encode.cu`` kernel gathers them, and the
decoder, whose parameters ``deblock_params_dec_fast`` gathers).
``deblock_params_dec_fast`` launches ``k_deblock_params_dec`` of
``csrc/deblock.cu`` on the per-MB words the decoder parsed, K pictures a
launch; on CPU tensors it runs ``deblock_params_dec_plain``.  There
is no other branch: a failed build or launch raises.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from hartallo_tpu_torch.core import tables as T
from hartallo_tpu_torch.encode.me_fast import _check, _device
from hartallo_tpu_torch.ops.deblock import PAD, deblock_filter, \
    deblock_frame_s1, edge_params
from hartallo_tpu_torch.ops.wide import compute_bs_grids

LAUNCHES = 0         # frames deblocked by the CUDA kernel in this process
PARAMS_LAUNCHES = 0  # launches of the decoder's parameter kernel
NAUX = 62
# The per-MB int32 words the decoder's deblock parameters read, as
# (name, shape) in the order of ``d_fused.DEC_FIELDS`` (where the GOP
# scan's dense buffer holds them, among others); the general route packs
# a record of these alone (``pack_deblock_record``).
DEBLOCK_FIELDS = (("kind", ()), ("qp", ()), ("mv", (4, 4, 2)),
                  ("ref_idx", (4,)), ("nnz", (4, 4)), ("alpha_off", ()),
                  ("beta_off", ()), ("fmb_v", ()), ("fmb_h", ()),
                  ("fint", ()))


def record_offsets(fields) -> tuple:
    """The word offsets of ``DEBLOCK_FIELDS`` in a record laid out as
    ``fields`` ((name, shape) pairs, one after another), and the record's
    words: ((10 offsets), words)."""
    offs, o = {}, 0
    for name, shape in fields:
        offs[name] = o
        o += int(np.prod(shape, dtype=int)) if shape else 1
    return tuple(offs[name] for name, _ in DEBLOCK_FIELDS), o


# the offsets of ``pack_deblock_record``'s record
RECORD_OFFSETS = record_offsets(DEBLOCK_FIELDS)[0]


def pack_deblock_record(values: dict, gw: int, gh: int) -> np.ndarray:
    """Host: the (gh*gw, words) int32 record of ``DEBLOCK_FIELDS`` from
    numpy arrays of shape (gh, gw) + the field's shape (``nnz`` per MB in
    raster order of its 4x4 blocks)."""
    return np.concatenate(
        [np.asarray(values[name], np.int32).reshape(
            gh * gw, int(np.prod(shape, dtype=int)) if shape else 1)
         for name, shape in DEBLOCK_FIELDS], axis=1)


@lru_cache(maxsize=None)
def _param_tables(device) -> torch.Tensor:
    """``k_deblock_params_dec``'s int32 table on ``device``, made once per
    device: QP_SCALE_CHROMA, DEBLOCK_ALPHA, DEBLOCK_BETA and DEBLOCK_TC0
    (the offsets DPT_* of ``csrc/deblock_params.cuh``).  Shared: never
    written."""
    return torch.as_tensor(np.concatenate(
        [np.asarray(t).ravel() for t in (T.QP_SCALE_CHROMA, T.DEBLOCK_ALPHA,
                                         T.DEBLOCK_BETA, T.DEBLOCK_TC0)])
        .astype(np.int32), device=device)


def deblock_params_dec_plain(rec, offsets, chroma_qp_off: int, *, gw: int,
                             gh: int):
    """The plain twin of ``deblock_params_dec_fast``: the eager chain of
    the GOP scan and the general route, ``compute_bs_grids`` (I4x4, I16,
    PCM and I_BL intra), the left and top QP and chroma QP maps (the edge
    MB its own) and ``edge_params`` with the per-MB offsets, batched over
    the K pictures.  Returns (K, gh, gw, NAUX) int16."""
    K = rec.shape[0]
    f = {}
    for (name, shape), o in zip(DEBLOCK_FIELDS, offsets):
        n = int(np.prod(shape, dtype=int)) if shape else 1
        f[name] = rec[:, :, o:o + n].reshape((K, gh, gw) + shape)
    kind = f["kind"]
    nnz = f["nnz"].permute(0, 1, 3, 2, 4).reshape(K, 4 * gh, 4 * gw)
    mvg = f["mv"].permute(0, 1, 3, 2, 4, 5).reshape(K, 4 * gh, 4 * gw, 2)
    ref44 = f["ref_idx"].reshape(K, gh, gw, 2, 2) \
        .repeat_interleave(2, 3).repeat_interleave(2, 4)
    refg = ref44.permute(0, 1, 3, 2, 4).reshape(K, 4 * gh, 4 * gw)
    bs_vg, bs_hg = compute_bs_grids((kind <= 2) | (kind == 8), nnz, mvg,
                                    refg, f["fmb_v"] != 0, f["fmb_h"] != 0,
                                    f["fint"] != 0)
    return edge_rows(bs_vg.reshape(K, gh, 4, gw, 4).permute(0, 1, 3, 4, 2),
                     bs_hg.reshape(K, gh, 4, gw, 4).permute(0, 1, 3, 2, 4),
                     f["qp"], chroma_qp_off, f["alpha_off"], f["beta_off"])


def edge_rows(bs_v, bs_h, qp, chroma_qp_off: int, alpha_off, beta_off):
    """``edge_params`` of K pictures as (K, gh, gw, NAUX) int16 rows, the
    end of both deblock parameter kernels' plain twins: bs_v, bs_h (K, gh,
    gw, 4, 4), qp and the slices' offsets (K, gh, gw).  The left and top
    MBs' QP and chroma QP maps are made here, the edge MB its own."""
    K, gh, gw = qp.shape
    qp = qp.to(torch.int32)
    qpc = _param_tables(qp.device)[:52][
        torch.clamp(qp + chroma_qp_off, 0, 51).long()]

    def left(a):
        return torch.cat([a[:, :, :1], a[:, :, :-1]], dim=2)

    def top(a):
        return torch.cat([a[:, :1], a[:, :-1]], dim=1)

    def rows(a):
        return a.reshape((K * gh, gw) + a.shape[3:])
    aux = edge_params(rows(bs_v), rows(bs_h),
                      *map(rows, (qp, left(qp), top(qp), qpc, left(qpc),
                                  top(qpc), alpha_off, beta_off)))
    return aux.reshape(K, gh, gw, NAUX).to(torch.int16)


def deblock_params_dec_fast(rec, offsets, chroma_qp_off: int, *, gw: int,
                            gh: int):
    """The decoder's deblock parameter rows of K pictures, (K, gh, gw,
    NAUX) int16, from their per-MB records: rec (K, gh*gw, words) int32,
    contiguous, with ``DEBLOCK_FIELDS`` at ``offsets`` (``record_offsets``).
    CUDA tensors -> one ``hl_deblock_params_dec`` launch; CPU tensors ->
    ``deblock_params_dec_plain``."""
    dev = _device("deblock_params_dec_fast", (rec,))
    if dev is None:
        return deblock_params_dec_plain(rec, offsets, chroma_qp_off, gw=gw,
                                        gh=gh)
    global PARAMS_LAUNCHES
    from hartallo_tpu_torch import kernels
    if rec.dtype != torch.int32 or \
            not rec.is_contiguous() or rec.dim() != 3 or \
            rec.shape[1] != gh * gw or len(offsets) != len(DEBLOCK_FIELDS):
        raise ValueError(f"deblock_params_dec_fast: rec {rec.dtype} "
                         f"{tuple(rec.shape)} on {rec.device}; it needs a "
                         f"contiguous int32 (K, {gh * gw}, words) tensor and "
                         f"{len(DEBLOCK_FIELDS)} offsets")
    K, _, words = rec.shape
    aux = torch.empty((K, gh, gw, NAUX), dtype=torch.int16, device=dev)
    offs = (ctypes.c_int * len(offsets))(*offsets)
    with torch.cuda.device(dev):
        rc = kernels.load().hl_deblock_params_dec(
            rec.data_ptr(), words, offs, _param_tables(dev).data_ptr(),
            aux.data_ptr(), K, gw, gh, int(chroma_qp_off),
            torch.cuda.current_stream(dev).cuda_stream)
    _check(rc, "hl_deblock_params_dec")
    PARAMS_LAUNCHES += 1
    return aux

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
