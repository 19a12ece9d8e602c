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

import numpy as np
import torch

from hartallo_tpu_torch.decode.intra_recon import PAD, intra_reconstruct
from hartallo_tpu_torch.encode.me_fast import _check, _device

LAUNCHES = 0         # pictures reconstructed by the CUDA kernel
# the kernel's block: the luma, chroma, edge, publishing and tap warps
THREADS = 160
# the row stride of the kernel's luma tile
_TW = 25


def _packed_modes() -> np.ndarray:
    """The directional Intra4x4 modes as ``csrc/intra_decode.cu`` reads
    them (T_WORDS): for each mode of ``ops/intra``'s tables (row 0, 1,
    2..7 = mode 0, 1, 3..8), without and with the top-right substitution
    (edge samples 9..12 read as 8), each sample 4 y + x of a block, two
    int32 words: the three taps' offsets in the kernel's tile from the
    block's top-left corner sample, 9 bits each (bits 0, 9, 18); their
    weights, 2 bits each (bits 0, 2, 4), the rounding (bits 8-15) and the
    shift (bits 16-17)."""
    from hartallo_tpu_torch.ops.intra import _IDX, _RND, _SHT, _WGT
    sub = np.array([False, True])[None, :, None, None, None]
    idx = np.where(sub & (_IDX[:, None] >= 9), 8, _IDX[:, None])
    # the edge vector [l3, l2, l1, l0, tl, t0..t7] in the tile
    off = np.where(idx <= 4, (4 - idx) * _TW, idx - 4)      # (8, 2, 4, 4, 3)
    w = np.broadcast_to(_WGT[:, None], off.shape)
    a = off[..., 0] | off[..., 1] << 9 | off[..., 2] << 18
    b = (w[..., 0] | w[..., 1] << 2 | w[..., 2] << 4 |
         _RND[:, None] << 8 | _SHT[:, None] << 16)
    return np.stack([a, b], -1).astype(np.int32).reshape(-1)


@lru_cache(maxsize=None)
def _tables(device) -> torch.Tensor:
    """``_packed_modes`` on ``device``, made once per device.  Shared:
    never written."""
    return torch.as_tensor(_packed_modes(), device=device)


def intra_reconstruct_fast(planes, res_y, res_c, mb_kind, i16_mode,
                           i4_modes, chroma_mode, avail_left, avail_top,
                           avail_tr=None, *, gw: int, gh: int):
    """``intra_reconstruct`` of one picture: CUDA tensors -> the CUDA
    kernel; CPU tensors -> the plain twin.  The maps may have any integer
    or bool dtype and any strides; the wrapper makes int32 (the flags
    bool) contiguous copies where they are not, and copies a residual
    that does not start on 16 bytes (the kernel reads it 16 bytes at a
    time)."""
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
        return t.clone() if t.data_ptr() % 16 else t
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
