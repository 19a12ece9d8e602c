"""The encoder's motion search as CUDA kernels, three launches per P
picture, and their plain twins.

Counterparts of ``hartallo_tpu/encode/me.py:full_search_int`` and
``refine_subpel``, the XLA code inside ``p_device.p_frame_device``.
``full_search_int_fast`` and ``refine_subpel_fast`` have the contracts of
``encode/me.full_search_int`` and ``refine_subpel``, their plain twins:
the same arguments and the same results.  On CUDA tensors they launch
``hl_full_search_int`` and ``hl_refine_subpel`` of ``csrc/me_search.cu``
(one block per MB each) on the planes' current CUDA stream; on CPU
tensors they run the twins.  There is no other branch: a failed build or
launch raises.  ``lam_motion`` may be a tensor on the device; the kernels
read it there, so a wrapper never waits for the card.
"""
from __future__ import annotations

import ctypes

import torch

from hartallo_tpu_torch.encode.me import full_search_int, refine_subpel
from hartallo_tpu_torch.ops.interpol import PAD
from hartallo_tpu_torch.ops.wide import halfpel_planes

FULL_SEARCH_LAUNCHES = 0   # full searches run by the CUDA kernel
REFINE_LAUNCHES = 0        # refinement rounds run by the CUDA kernel


def _device(name: str, *args):
    """None where every tensor argument lies on the CPU, else their one
    CUDA device; raises on anything else."""
    devices = {a.device for a in args if isinstance(a, torch.Tensor)}
    kinds = {d.type for d in devices}
    if kinds == {"cpu"}:
        return None
    if kinds != {"cuda"} or len(devices) != 1:
        raise ValueError(f"{name}: tensors on {sorted(map(str, devices))}; "
                         "all must be on one CUDA device or all on the CPU")
    return devices.pop()


def _plane(p, rows: int, cols: int, name: str, device) -> torch.Tensor:
    """A 2-D int32 plane on ``device`` with at least rows x cols."""
    p = torch.as_tensor(p, device=device).to(torch.int32).contiguous()
    if p.dim() != 2 or p.shape[0] < rows or p.shape[1] < cols:
        raise ValueError(f"{name} has shape {tuple(p.shape)}; it needs 2 "
                         f"dims and at least {rows} x {cols}")
    return p


def _lam(lam_motion, device) -> torch.Tensor:
    return torch.as_tensor(lam_motion, dtype=torch.float32,
                           device=device).reshape(1)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check(rc: int, name: str) -> None:
    if rc != 0:
        from hartallo_tpu_torch import kernels
        raise RuntimeError(f"{name}: CUDA error {rc} "
                           f"({kernels.error_string(rc)})")


def full_search_int_fast(src_pad, ref_pad, lam_motion, *, gw: int, gh: int,
                         rng: int):
    """``full_search_int``: CUDA tensors -> ``hl_full_search_int``; CPU
    tensors -> the plain twin.  The planes are PAD-padded and may differ
    in shape (a band's reference carries its halo); each is read with its
    own row stride, as the twin's strided view does."""
    device = _device("full_search_int_fast", src_pad, ref_pad, lam_motion)
    if device is None:
        return full_search_int(src_pad, ref_pad, lam_motion, gw=gw, gh=gh,
                               rng=rng)
    global FULL_SEARCH_LAUNCHES
    from hartallo_tpu_torch import kernels
    if not 0 <= rng <= PAD:
        raise ValueError(f"full_search_int_fast: rng {rng} outside "
                         f"[0, {PAD}]")
    H, W = gh * 16, gw * 16
    src = _plane(src_pad, PAD + H, PAD + W, "src_pad", device)
    ref = _plane(ref_pad, PAD + H + rng, PAD + W + rng, "ref_pad", device)
    lam = _lam(lam_motion, device)
    out = []
    for shape in ((gh, gw), (gh, gw, 2), (gh, gw, 2), (gh, gw, 2, 2),
                  (gh, gw, 2), (gh, gw, 2, 2), (gh, gw, 4), (gh, gw, 4, 2)):
        dtype = torch.int32 if len(out) % 2 else torch.float32
        out.append(torch.empty(shape, dtype=dtype, device=device))
    with torch.cuda.device(device):
        rc = kernels.load().hl_full_search_int(
            *map(_ptr, (src, ref, lam, *out)), src.stride(0), ref.stride(0),
            gw, gh, rng,
            ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    _check(rc, "hl_full_search_int")
    FULL_SEARCH_LAUNCHES += 1
    return tuple(out)


def refine_subpel_fast(src_pad, ref_pad, mv_blk, part_of_blk, lam_motion,
                       step_qpel: int, *, gw: int, gh: int, nparts: int,
                       use_satd: bool = True, hp=None):
    """``refine_subpel``, one round: CUDA tensors -> ``hl_refine_subpel``;
    CPU tensors -> the plain twin.  ``hp`` is the half-pel stack
    ``halfpel_planes(ref_pad)`` (4, Hp, Wp), or (S, 4, Hp, Wp) of which
    slot 0 is read, as the twin does; computed here where it is None."""
    device = _device("refine_subpel_fast", src_pad, ref_pad, mv_blk,
                     part_of_blk, lam_motion, hp)
    if device is None:
        return refine_subpel(src_pad, ref_pad, mv_blk, part_of_blk,
                             lam_motion, step_qpel, gw=gw, gh=gh,
                             nparts=nparts, use_satd=use_satd, hp=hp)
    global REFINE_LAUNCHES
    from hartallo_tpu_torch import kernels
    if not 1 <= nparts <= 16:
        raise ValueError(f"refine_subpel_fast: nparts {nparts} outside "
                         "[1, 16]")
    H, W = gh * 16, gw * 16
    src = _plane(src_pad, PAD + H, PAD + W, "src_pad", device)
    if hp is None:
        hp = halfpel_planes(ref_pad)
    hp = (hp[0] if hp.dim() == 4 else hp).to(torch.int32).contiguous()
    if hp.dim() != 3 or hp.shape[0] != 4 or \
            hp.shape[1] < H + 2 * PAD - 2 or hp.shape[2] < W + 2 * PAD - 2:
        raise ValueError(f"refine_subpel_fast: hp has shape "
                         f"{tuple(hp.shape)}; it needs (4, Hp, Wp) with Hp "
                         f">= {H + 2 * PAD - 2} and Wp >= {W + 2 * PAD - 2}")
    mv = torch.as_tensor(mv_blk, device=device).to(torch.int32).contiguous()
    part = torch.as_tensor(part_of_blk, device=device).to(torch.int32) \
        .contiguous()
    if tuple(mv.shape) != (gh, gw, 16, 2) or \
            tuple(part.shape) != (gh, gw, 16):
        raise ValueError(f"refine_subpel_fast: mv_blk {tuple(mv.shape)} and "
                         f"part_of_blk {tuple(part.shape)}, expected "
                         f"{(gh, gw, 16, 2)} and {(gh, gw, 16)}")
    lam = _lam(lam_motion, device)
    mv_out = torch.empty_like(mv)
    cost = torch.empty((gh, gw, nparts), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        rc = kernels.load().hl_refine_subpel(
            *map(_ptr, (src, hp, mv, part, lam, mv_out, cost)),
            src.stride(0), hp.shape[1], hp.shape[2], gw, gh, nparts,
            int(step_qpel), int(bool(use_satd)),
            ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    _check(rc, "hl_refine_subpel")
    REFINE_LAUNCHES += 1
    return mv_out, cost
