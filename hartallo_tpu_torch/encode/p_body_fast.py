"""The encoder's P-picture body around the motion search as four CUDA
kernels, and their plain twins.

Counterparts of the XLA program of ``hartallo_tpu/encode/e_device.py``
``p_gop_fused`` outside the motion search and the intra wavefront, in
``csrc/p_encode.cu``:

- ``partition_decide_fast`` -> ``hl_part_decide``; twin
  ``p_device.partition_decide`` (the partition decision);
- ``halfpel_planes_fast`` -> ``hl_halfpel_enc``; twin
  ``ops/wide.halfpel_planes`` (the refinement's half-pel stack);
- ``p_residual_fast`` -> ``hl_p_residual``; twin ``p_device.p_residual``
  (quarter-pel and chroma MC, the luma and chroma transform,
  quantisation, JVT-O079 eliminations, dequantisation, inverse transform
  and edge-padded recon, and the intra-in-P mask);
- ``deblock_params_fast`` -> ``hl_deblock_params``; twin
  ``e_device.deblock_params`` (``compute_bs`` and ``edge_params`` of the
  in-loop deblock, as the int16 rows ``ops/deblock_fast`` launches on).

Each wrapper has its twin's arguments and results.  On CUDA tensors it
launches its kernel on the current CUDA stream and adds one to its entry
of ``LAUNCHES``; on CPU tensors it runs the twin.  There is no other
branch: a failed build or launch raises.  On CUDA tensors the wrappers
convert nothing: another dtype, shape or stride than the kernel takes
raises ``ValueError``.  The twins are imported where a wrapper runs one,
since ``p_device`` and ``e_device`` call these wrappers.
"""
from __future__ import annotations

import contextlib
from functools import lru_cache

import numpy as np
import torch

from hartallo_tpu_torch.core import tables as T
from hartallo_tpu_torch.encode.me_fast import _check, _device, _lam, _plane
from hartallo_tpu_torch.ops.interpol import PAD
from hartallo_tpu_torch.ops.wide import halfpel_planes

NAUX = 62
# kernel launches in this process, by wrapper
LAUNCHES = {"part_decide": 0, "halfpel": 0, "p_residual": 0,
            "deblock_params": 0}


@lru_cache(maxsize=None)
def _tables(device) -> torch.Tensor:
    """The kernels' int32 table on ``device``, made once per device:
    QUANT_MF, QUANT_V, QUANT_QBITS, the inter row of QUANT_F,
    QP_SCALE_CHROMA, DEBLOCK_ALPHA, DEBLOCK_BETA, DEBLOCK_TC0 and
    ZIGZAG_4x4_INV (the offsets T_* of ``csrc/p_encode.cu``).  Shared:
    never written."""
    parts = (T.QUANT_MF, T.QUANT_V, T.QUANT_QBITS, np.asarray(T.QUANT_F)[1],
             T.QP_SCALE_CHROMA, T.DEBLOCK_ALPHA, T.DEBLOCK_BETA,
             T.DEBLOCK_TC0, T.ZIGZAG_4x4_INV)
    return torch.as_tensor(np.concatenate(
        [np.asarray(p).ravel() for p in parts]).astype(np.int32),
        device=device)


def _tensor(a: torch.Tensor, dtype, shape: tuple, name: str,
            align: int = 1) -> None:
    """Raise unless ``a`` is a contiguous ``dtype`` tensor of ``shape``
    whose data starts ``align``-byte aligned (the kernel's vector loads)."""
    if a.dtype != dtype or not a.is_contiguous() or \
            tuple(a.shape) != shape or a.data_ptr() % align:
        raise ValueError(f"{name}: {a.dtype} {tuple(a.shape)}; it needs "
                         f"{dtype}, contiguous, {shape}" +
                         (f", {align}-byte aligned" if align > 1 else ""))


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _on(device):
    """A context in which ``device`` is the current CUDA device, where the
    launch goes: none where it already is (entering torch.cuda.device
    costs the host more than the check)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


@lru_cache(maxsize=None)
def _residual_layout(gw: int, gh: int):
    """The residual kernel's six int32 outputs (wq, dcq, acq, recY, recU,
    recV) as (shape, stride, offset) in one allocation of the returned
    length: each contiguous, each starting 16-byte aligned (every size is
    a multiple of 4 samples)."""
    luma = (gh * 16 + 2 * PAD, gw * 16 + 2 * PAD)
    chroma = (gh * 8 + 2 * PAD, gw * 8 + 2 * PAD)
    views, off = [], 0
    for shape in ((gh, gw, 16, 4, 4), (gh, gw, 2, 2, 2),
                  (gh, gw, 2, 4, 4, 4), luma, chroma, chroma):
        stride = tuple(int(np.prod(shape[i + 1:])) for i in range(len(shape)))
        views.append((shape, stride, off))
        off += int(np.prod(shape))
    return off, tuple(views)


@lru_cache(maxsize=None)
def _decide_layout(gw: int, gh: int):
    """The partition kernel's four outputs (mv_blk int32, part_of_blk
    int32, choice int64, best_cost f32) as (shape, stride, offset in
    elements of its dtype) in one allocation of the returned number of
    int32 words: each contiguous, the int32 maps 16-byte aligned and
    choice 8-byte aligned."""
    n = gw * gh
    return 51 * n + (n & 1), (
        ((gh, gw, 16, 2), (gw * 32, 32, 2, 1), 0),
        ((gh, gw, 16), (gw * 16, 16, 1), 32 * n),
        ((gh, gw), (gw, 1), 24 * n),          # int64 words
        ((gh, gw), (gw, 1), 50 * n))


def partition_decide_fast(fs, lam, *, gw: int, gh: int):
    """``p_device.partition_decide`` of the full search's eight outputs
    ``fs``: CUDA tensors -> ``hl_part_decide``; CPU tensors -> the twin.
    Returns (choice int64 (gh, gw), best_cost f32 (gh, gw), mv_blk int32
    (gh, gw, 16, 2) quarter-pel, part_of_blk int32 (gh, gw, 16)); on the
    card the four are views of one allocation (``_decide_layout``).  The
    integer MV maps of ``fs`` must be 8-byte aligned."""
    name = "partition_decide_fast"
    device = _device(name, fs)
    if device is None:
        from hartallo_tpu_torch.encode.p_device import partition_decide
        return partition_decide(fs, lam, gw=gw, gh=gh)
    from hartallo_tpu_torch import kernels
    shapes = ((gh, gw), (gh, gw, 2), (gh, gw, 2), (gh, gw, 2, 2),
              (gh, gw, 2), (gh, gw, 2, 2), (gh, gw, 4), (gh, gw, 4, 2))
    for i, (t, shape) in enumerate(zip(fs, shapes)):
        _tensor(t, torch.int32 if i % 2 else torch.float32, shape,
                f"{name}: output {i} of the full search", 8 if i % 2 else 1)
    lam_t = _lam(lam, device)
    # one allocation for the four outputs, each a view of its own
    words, (v_mv, v_part, v_choice, v_best) = _decide_layout(gw, gh)
    flat = torch.empty(words, dtype=torch.int32, device=device)
    mv, part = flat.as_strided(*v_mv), flat.as_strided(*v_part)
    choice = flat.view(torch.int64).as_strided(*v_choice)
    best = flat.view(torch.float32).as_strided(*v_best)
    with _on(device):
        rc = kernels.load().hl_part_decide(
            *(t.data_ptr() for t in fs), lam_t.data_ptr(),
            choice.data_ptr(), best.data_ptr(), mv.data_ptr(),
            part.data_ptr(), gw * gh, _stream(device))
    _check(rc, "hl_part_decide")
    LAUNCHES["part_decide"] += 1
    return choice, best, mv, part


def halfpel_planes_fast(pad_plane: torch.Tensor) -> torch.Tensor:
    """``ops/wide.halfpel_planes``: the (4, Hp, Wp) int32 stack [G, b, h,
    j] of an edge-padded (Hp, Wp) plane.  A CUDA tensor (int32, unit
    column stride) -> ``hl_halfpel_enc``; a CPU tensor -> the twin."""
    device = _device("halfpel_planes_fast", (pad_plane,))
    if device is None:
        return halfpel_planes(pad_plane)
    from hartallo_tpu_torch import kernels
    _plane(pad_plane, 1, 1, "halfpel_planes_fast")
    hp, wp = pad_plane.shape
    out = torch.empty((4, hp, wp), dtype=torch.int32, device=device)
    with _on(device):
        rc = kernels.load().hl_halfpel_enc(
            pad_plane.data_ptr(), pad_plane.stride(0), hp, wp,
            out.data_ptr(), _stream(device))
    _check(rc, "hl_halfpel_enc")
    LAUNCHES["halfpel"] += 1
    return out


def p_residual_fast(srcY, srcU, srcV, refY, refU, refV, mv_blk, qp,
                    best_cost, lam, *, gw: int, gh: int, chroma_qp_off: int,
                    intra_in_p: bool):
    """``p_device.p_residual``: CUDA tensors -> one ``hl_p_residual``
    launch; CPU tensors -> the twin.  The planes are PAD-padded int32 with
    unit column stride (each read with its own row stride; the reference
    planes may be a band's halo planes, of the source's size); mv_blk
    int32 (gh, gw, 16, 2), qp int32 (gh, gw), best_cost f32 (gh, gw), all
    contiguous.  Returns (wq, dcq, acq, recY, recU, recV, mask): the recon
    planes edge-padded, contiguous int32; mask the (gh, gw) bool
    intra-in-P decision, None without ``intra_in_p``."""
    name = "p_residual_fast"
    device = _device(name, (srcY, srcU, srcV, refY, refU, refV, mv_blk, qp,
                            best_cost))
    if device is None:
        from hartallo_tpu_torch.encode.p_device import p_residual
        return p_residual(srcY, srcU, srcV, refY, refU, refV, mv_blk, qp,
                          best_cost, lam, gw=gw, gh=gh,
                          chroma_qp_off=chroma_qp_off, intra_in_p=intra_in_p)
    from hartallo_tpu_torch import kernels
    total, views = _residual_layout(gw, gh)
    planes = (srcY, srcU, srcV, refY, refU, refV)
    for p, (shape, _, _), n in zip(planes, views[3:] * 2,
                                   ("srcY", "srcU", "srcV", "refY", "refU",
                                    "refV")):
        if p.dtype != torch.int32 or p.stride(1) != 1 or p.shape != shape:
            raise ValueError(f"{name}: {n} {p.dtype} {tuple(p.shape)} "
                             f"with strides {p.stride()}; it needs int32, "
                             f"unit column stride and {shape}")
    _tensor(mv_blk, torch.int32, (gh, gw, 16, 2), f"{name}: mv_blk")
    _tensor(qp, torch.int32, (gh, gw), f"{name}: qp")
    _tensor(best_cost, torch.float32, (gh, gw), f"{name}: best_cost")
    lam_t = _lam(lam, device)
    # one allocation for the six int32 outputs, each a view of its own
    flat = torch.empty(total, dtype=torch.int32, device=device)
    out = [flat.as_strided(*v) for v in views]
    mask = torch.empty((gh, gw), dtype=torch.bool, device=device) \
        if intra_in_p else None
    with _on(device):
        rc = kernels.load().hl_p_residual(
            *[t.data_ptr() for t in (*planes, mv_blk, qp, best_cost, lam_t,
                                     _tables(device))],
            *[t.data_ptr() for t in out],
            None if mask is None else mask.data_ptr(),
            *[p.stride(0) for p in planes], *refY.shape, *refU.shape, gw,
            gh, int(chroma_qp_off), _stream(device))
    _check(rc, "hl_p_residual")
    LAUNCHES["p_residual"] += 1
    return (*out, mask)


def deblock_params_fast(wq, mv44, ref44, mb_is_intra, qp, chroma_qp_off,
                        fmb_v=None, fmb_h=None, *, gw: int, gh: int):
    """``e_device.deblock_params``: the in-loop deblock's (gh, gw, NAUX)
    int16 parameter rows of a coded picture.  CUDA tensors -> one
    ``hl_deblock_params`` launch; CPU tensors -> the twin.  wq int32 (gh,
    gw, 16, 4, 4), mv44 int32 (gh, gw, 4, 4, 2), ref44 int32 (gh, gw, 4,
    4), mb_is_intra bool (gh, gw), qp int32 (gh, gw), all contiguous, wq
    16-byte and mv44 8-byte aligned; the MB edge flags fmb_v / fmb_h (gh,
    gw) bool, tensors on the device (the encoder's, made once per slice
    layout) or numpy, uploaded here (None: every MB edge inside the
    picture)."""
    name = "deblock_params_fast"
    device = _device(name, (wq, mv44, ref44, mb_is_intra, qp) + tuple(
        f for f in (fmb_v, fmb_h) if isinstance(f, torch.Tensor)))
    if device is None:
        from hartallo_tpu_torch.encode.e_device import deblock_params
        return deblock_params(wq, mv44, ref44, mb_is_intra, qp,
                              chroma_qp_off, fmb_v, fmb_h, gw=gw, gh=gh)
    from hartallo_tpu_torch import kernels
    _tensor(wq, torch.int32, (gh, gw, 16, 4, 4), f"{name}: wq", 16)
    _tensor(mv44, torch.int32, (gh, gw, 4, 4, 2), f"{name}: mv44", 8)
    _tensor(ref44, torch.int32, (gh, gw, 4, 4), f"{name}: ref44")
    _tensor(mb_is_intra, torch.bool, (gh, gw), f"{name}: mb_is_intra")
    _tensor(qp, torch.int32, (gh, gw), f"{name}: qp")
    flags = []
    for f, n in ((fmb_v, "fmb_v"), (fmb_h, "fmb_h")):
        if f is not None and not isinstance(f, torch.Tensor):
            f = torch.as_tensor(np.asarray(f, bool), device=device)
        if f is not None:
            _tensor(f, torch.bool, (gh, gw), f"{name}: {n}")
        flags.append(f)
    aux = torch.empty((gh, gw, NAUX), dtype=torch.int16, device=device)
    with _on(device):
        rc = kernels.load().hl_deblock_params(
            wq.data_ptr(), mv44.data_ptr(), ref44.data_ptr(),
            mb_is_intra.data_ptr(), qp.data_ptr(),
            *(None if f is None else f.data_ptr() for f in flags),
            _tables(device).data_ptr(), aux.data_ptr(), gw, gh,
            int(chroma_qp_off), _stream(device))
    _check(rc, "hl_deblock_params")
    LAUNCHES["deblock_params"] += 1
    return aux
