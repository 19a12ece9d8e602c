"""The encoder's intra wavefront as one CUDA kernel launch per picture,
and its plain twin.

Counterpart of ``hartallo_tpu/encode/intra_encode.py:intra_encode_frame``,
the XLA wavefront inside ``e_device.i_frame_fused`` (IDR pictures) and
``p_gop_fused`` (P pictures with intra MBs).  ``intra_encode_frame_fast``
has the contract of ``encode/intra_encode.intra_encode_frame``, its plain
twin: the same arguments and the same (recY, recU, recV, arrays) result,
every output int32 (the twin's recon planes are int64, of equal
values).
On CUDA tensors it launches ``hl_intra_encode_frame`` of
``csrc/intra_encode.cu`` (one cooperative block of ``THREADS`` per MB row,
the rows spinning on per-row progress counters that the wrapper zeroes
on the stream) on the planes' current CUDA stream; on CPU tensors it
runs the twin.  There is no other branch: a failed build or a refused
launch raises.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from hartallo_tpu_torch.core import tables as T
from hartallo_tpu_torch.decode.intra_recon import PAD
from hartallo_tpu_torch.encode.intra_encode import intra_encode_frame

LAUNCHES = 0         # pictures encoded by the CUDA kernel in this process
# the kernel's block: two Intra4x4 warps, an Intra16x16 and a chroma warp
THREADS = 128


@lru_cache(maxsize=None)
def _tables(device) -> torch.Tensor:
    """The kernel's int32 table on ``device``, made once per device:
    QUANT_MF, QUANT_V, QUANT_QBITS, the intra row of QUANT_F and
    QP_SCALE_CHROMA (the offsets T_* of ``csrc/intra_encode.cu``).
    Shared: never written."""
    parts = (T.QUANT_MF, T.QUANT_V, T.QUANT_QBITS, np.asarray(T.QUANT_F)[0],
             T.QP_SCALE_CHROMA)
    return torch.as_tensor(np.concatenate(
        [np.asarray(p).ravel() for p in parts]).astype(np.int32),
        device=device)


def intra_encode_frame_fast(src_y, src_u, src_v, qp, chroma_qp_off,
                            avail_left, avail_top, lam, avail_tr=None,
                            avail_tl=None, base_planes=None, mb_mask=None,
                            *, gw: int, gh: int):
    """``intra_encode_frame`` of one picture: CUDA tensors -> the CUDA
    kernel; CPU tensors -> the plain twin.  Arguments that are not tensors
    (numpy maps, a float ``lam``) go with the tensors' device."""
    args = (src_y, src_u, src_v, qp, avail_left, avail_top, lam, avail_tr,
            avail_tl, mb_mask, *(base_planes or ()))
    devices = {a.device for a in args if isinstance(a, torch.Tensor)}
    kinds = {d.type for d in devices}
    if kinds == {"cpu"}:
        return intra_encode_frame(
            src_y, src_u, src_v, qp, chroma_qp_off, avail_left, avail_top,
            lam, avail_tr, avail_tl, base_planes, mb_mask, gw=gw, gh=gh)
    if kinds != {"cuda"} or len(devices) != 1:
        raise ValueError(f"intra_encode_frame_fast: tensors on "
                         f"{sorted(map(str, devices))}; all must be on one "
                         "CUDA device or all on the CPU")
    return _launch(src_y, src_u, src_v, qp, chroma_qp_off, avail_left,
                   avail_top, lam, avail_tr, avail_tl, base_planes, mb_mask,
                   gw=gw, gh=gh, device=devices.pop())


def _plane(p, shape, name: str, device) -> torch.Tensor:
    p = torch.as_tensor(p, device=device).to(torch.int32).contiguous()
    if tuple(p.shape) != shape:
        raise ValueError(f"plane {name} has shape {tuple(p.shape)}, "
                         f"expected {shape}")
    return p


def _map(a, dtype, gw: int, gh: int, name: str, device):
    """A (gh, gw) map as a contiguous tensor of ``dtype``, or None."""
    if a is None:
        return None
    t = torch.as_tensor(a, device=device).to(dtype).contiguous()
    if tuple(t.shape) != (gh, gw):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{(gh, gw)}")
    return t


def _launch(src_y, src_u, src_v, qp, chroma_qp_off, avail_left, avail_top,
            lam, avail_tr, avail_tl, base_planes, mb_mask, *, gw: int,
            gh: int, device):
    global LAUNCHES
    from hartallo_tpu_torch import kernels
    # the per-MB arrays in the kernel's argument order
    from hartallo_tpu_torch.encode.e_device import INTRA_FIELDS

    H, W = gh * 16, gw * 16
    shapes = ((H + 2 * PAD, W + 2 * PAD),
              (H // 2 + 2 * PAD, W // 2 + 2 * PAD),
              (H // 2 + 2 * PAD, W // 2 + 2 * PAD))
    src = [_plane(p, s, n, device)
           for p, s, n in zip((src_y, src_u, src_v), shapes, "YUV")]
    base = [None] * 3 if base_planes is None else \
        [_plane(p, s, f"base {n}", device)
         for p, s, n in zip(base_planes, shapes, "YUV")]
    qp_t = _map(qp, torch.int32, gw, gh, "qp", device)
    flags = [_map(a, torch.bool, gw, gh, n, device) for a, n in
             ((avail_left, "avail_left"), (avail_top, "avail_top"),
              (avail_tr, "avail_tr"), (avail_tl, "avail_tl"),
              (mb_mask, "mb_mask"))]
    if flags[0] is None or flags[1] is None:
        raise ValueError("avail_left and avail_top are required")
    lam_t = torch.as_tensor(lam, dtype=torch.float32,
                            device=device).reshape(1)
    rec = [torch.zeros(s, dtype=torch.int32, device=device) for s in shapes]
    arrays = {name: torch.empty((gh, gw, *shape), dtype=torch.int32,
                                device=device)
              for name, shape in INTRA_FIELDS}
    prog = torch.zeros(gh, dtype=torch.int32, device=device)

    def ptr(t):
        return ctypes.c_void_p(None if t is None else t.data_ptr())
    lib = kernels.load()
    with torch.cuda.device(device):
        rc = lib.hl_intra_encode_frame(
            *map(ptr, (*src, *base, qp_t, *flags, _tables(device), lam_t,
                       *rec, *arrays.values(), prog)),
            gw, gh, int(chroma_qp_off), THREADS,
            ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"hl_intra_encode_frame: CUDA error {rc} "
                           f"({kernels.error_string(rc)})")
    LAUNCHES += 1
    return (*rec, arrays)
