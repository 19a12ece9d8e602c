"""The decoder's intra reconstruction as one CUDA kernel launch per
picture, and its plain twin.

Counterpart of ``hartallo_tpu/decode/intra_recon.py:intra_reconstruct``,
the XLA wavefront of the GOP scan's intra branch, the general route and
the sharded band step.  ``intra_reconstruct_fast`` has the contract of
``decode/intra_recon.intra_reconstruct``, its plain twin: the same
arguments and the same three new PAD-padded int32 planes, the inputs
untouched.  On CUDA tensors it launches ``hl_intra_decode`` of
``csrc/intra_decode.cu`` (one cooperative block of ``THREADS`` per MB
row, the rows spinning on per-row progress counters that the wrapper
zeroes on the stream) on the planes' current CUDA stream; on CPU tensors
it runs the twin.  There is no other branch: a failed build or a refused
launch raises.
"""
from __future__ import annotations

from functools import lru_cache

import torch

from hartallo_tpu_torch.decode.intra_recon import PAD, intra_reconstruct
from hartallo_tpu_torch.encode.me_fast import _check, _device

LAUNCHES = 0         # pictures reconstructed by the CUDA kernel
# the kernel's block: a luma warp and a chroma warp
THREADS = 64


@lru_cache(maxsize=None)
def _tables(device) -> torch.Tensor:
    """The Intra4x4 mode tables on ``device`` (``d_gop_fast._i4tab``, the
    offsets T_* of ``csrc/intra_decode.cu``), made once per device.
    Shared: never written."""
    from hartallo_tpu_torch.decode.d_gop_fast import _i4tab
    return _i4tab(device)


def intra_reconstruct_fast(planes, res_y, res_c, mb_kind, i16_mode,
                           i4_modes, chroma_mode, avail_left, avail_top,
                           avail_tr=None, *, gw: int, gh: int):
    """``intra_reconstruct`` of one picture: CUDA tensors -> the CUDA
    kernel; CPU tensors -> the plain twin.  The maps may have any integer
    or bool dtype and any strides; the wrapper makes int32 (the flags
    bool) contiguous copies where they are not."""
    args = (*planes, res_y, res_c, mb_kind, i16_mode, i4_modes, chroma_mode,
            avail_left, avail_top) + (() if avail_tr is None else (avail_tr,))
    device = _device("intra_reconstruct_fast", args)
    if device is None:
        return intra_reconstruct(planes, res_y, res_c, mb_kind, i16_mode,
                                 i4_modes, chroma_mode, avail_left,
                                 avail_top, avail_tr, gw=gw, gh=gh)
    global LAUNCHES
    from hartallo_tpu_torch import kernels

    H, W = gh * 16, gw * 16
    shapes = ((H + 2 * PAD, W + 2 * PAD),
              (H // 2 + 2 * PAD, W // 2 + 2 * PAD),
              (H // 2 + 2 * PAD, W // 2 + 2 * PAD))
    src = []
    for p, shape, name in zip(planes, shapes, "YUV"):
        if tuple(p.shape) != shape:
            raise ValueError(f"intra_reconstruct_fast: plane {name} has "
                             f"shape {tuple(p.shape)}, expected {shape}")
        src.append(p.to(torch.int32).contiguous())
    out = [p.clone() for p in src]

    def fit(t, dtype, shape, name):
        t = t.to(dtype).contiguous()
        if tuple(t.shape) != shape:
            raise ValueError(f"intra_reconstruct_fast: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        return t
    maps = [fit(t, torch.int32, s, n) for t, s, n in (
        (res_y, (gh, gw, 16, 16), "res_y"), (res_c, (gh, gw, 2, 8, 8),
                                             "res_c"),
        (mb_kind, (gh, gw), "mb_kind"), (i16_mode, (gh, gw), "i16_mode"),
        (i4_modes, (gh, gw, 16), "i4_modes"),
        (chroma_mode, (gh, gw), "chroma_mode"))]
    flags = [None if t is None else fit(t, torch.bool, (gh, gw), n)
             for t, n in ((avail_left, "avail_left"),
                          (avail_top, "avail_top"), (avail_tr, "avail_tr"))]
    prog = torch.zeros(gh, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        rc = kernels.load().hl_intra_decode(
            *(None if t is None else t.data_ptr() for t in
              (*src, *out, *maps, *flags, _tables(device), prog)),
            gw, gh, THREADS, torch.cuda.current_stream(device).cuda_stream)
    _check(rc, "hl_intra_decode")
    LAUNCHES += 1
    return tuple(out)
