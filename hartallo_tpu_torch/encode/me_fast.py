"""The encoder's motion search as CUDA kernels, two launches per P picture,
and their plain twins.

Counterparts of ``hartallo_tpu/encode/me.py:full_search_int`` and
``refine_subpel``, the XLA code inside ``p_device.p_frame_device``.
``full_search_int_fast`` and ``refine_subpel_fast`` have the contracts of
``encode/me.full_search_int`` and ``refine_subpel``, their plain twins:
the same arguments and the same results; ``refine_subpel_rounds_fast``
runs one or two refinement rounds, the twin's chain, in one launch.  On
CUDA tensors they launch ``hl_full_search_int`` and ``hl_refine_subpel``
of ``csrc/me_search.cu`` on the current CUDA stream; on CPU tensors they
run the twins.  There is no other branch: a failed build or launch
raises.  ``lam_motion`` may be a tensor on the device; the kernels read it
there, so a wrapper never waits for the card.

On CUDA tensors the wrappers convert nothing: the planes are int32 with
unit column stride (any row stride), the MV and partition maps int32 and
contiguous, and every plane sample is in 0..255 (the source is packed
from uint8, the reference is a clamped recon, pads copy samples), which
the full search relies on without a check on the card.  Anything else
raises ``ValueError``.
"""
from __future__ import annotations

import torch

from hartallo_tpu_torch.encode.me import full_search_int, refine_subpel
from hartallo_tpu_torch.ops.interpol import PAD
from hartallo_tpu_torch.ops.wide import halfpel_planes

RF_MAX_STEP = 8            # csrc/me_search.cu: the widest staged window
FULL_SEARCH_LAUNCHES = 0   # full searches run by the CUDA kernel
REFINE_LAUNCHES = 0        # refinement launches (one or two rounds each)


def _device(name: str, tensors):
    """None where every tensor lies on the CPU, else their one CUDA
    device; raises on anything else."""
    dev = tensors[0].device
    if all(t.device == dev for t in tensors[1:]) and \
            dev.type in ("cpu", "cuda"):
        return None if dev.type == "cpu" else dev
    raise ValueError(f"{name}: tensors on "
                     f"{sorted({str(t.device) for t in tensors})}; all must "
                     "be on one CUDA device or all on the CPU")


def _plane(p: torch.Tensor, rows: int, cols: int, name: str) -> None:
    """Raise unless ``p`` is a 2-D int32 plane with unit column stride and
    at least rows x cols."""
    if p.dtype != torch.int32 or p.dim() != 2 or p.stride(1) != 1 or \
            p.shape[0] < rows or p.shape[1] < cols:
        raise ValueError(f"{name}: {p.dtype} {tuple(p.shape)} with strides "
                         f"{p.stride()}; it needs int32, 2 dims, unit column "
                         f"stride and at least {rows} x {cols}")


def _map(a: torch.Tensor, shape: tuple, name: str) -> None:
    if a.dtype != torch.int32 or not a.is_contiguous() or \
            tuple(a.shape) != shape:
        raise ValueError(f"{name}: {a.dtype} {tuple(a.shape)}; it needs "
                         f"int32, contiguous, {shape}")


def _lam(lam_motion, device) -> torch.Tensor:
    """One f32 on ``device``: the tensor itself where it is one, else a
    copy."""
    if isinstance(lam_motion, torch.Tensor) and \
            lam_motion.dtype == torch.float32 and \
            lam_motion.device == device and lam_motion.numel() == 1:
        return lam_motion
    return torch.as_tensor(lam_motion, dtype=torch.float32, device=device)


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
    own row stride, as the twin's strided view does.  The kernel keeps
    the planes as bytes: their samples must be in 0..255 (not checked)."""
    device = _device("full_search_int_fast", (src_pad, ref_pad))
    if device is None:
        return full_search_int(src_pad, ref_pad, lam_motion, gw=gw, gh=gh,
                               rng=rng)
    global FULL_SEARCH_LAUNCHES
    from hartallo_tpu_torch import kernels
    if not 0 <= rng <= PAD:
        raise ValueError(f"full_search_int_fast: rng {rng} outside "
                         f"[0, {PAD}]")
    H, W = gh * 16, gw * 16
    _plane(src_pad, PAD + H, PAD + W, "full_search_int_fast: src_pad")
    _plane(ref_pad, PAD + H + rng, PAD + W + rng,
           "full_search_int_fast: ref_pad")
    lam = _lam(lam_motion, device)
    out = []
    for shape in ((gh, gw), (gh, gw, 2), (gh, gw, 2), (gh, gw, 2, 2),
                  (gh, gw, 2), (gh, gw, 2, 2), (gh, gw, 4), (gh, gw, 4, 2)):
        dtype = torch.int32 if len(out) % 2 else torch.float32
        out.append(torch.empty(shape, dtype=dtype, device=device))
    with torch.cuda.device(device):
        rc = kernels.load().hl_full_search_int(
            src_pad.data_ptr(), ref_pad.data_ptr(), lam.data_ptr(),
            *(o.data_ptr() for o in out), src_pad.stride(0),
            ref_pad.stride(0), gw, gh, rng,
            torch.cuda.current_stream(device).cuda_stream)
    _check(rc, "hl_full_search_int")
    FULL_SEARCH_LAUNCHES += 1
    return tuple(out)


def refine_subpel_rounds_fast(src_pad, ref_pad, mv_blk, part_of_blk,
                              lam_motion, steps, *, gw: int, gh: int,
                              nparts: int, use_satd: bool = True, hp=None):
    """``refine_subpel`` chained over ``steps`` (one or two quarter-pel
    steps; ``p_device`` gives (2, 1)), each round on the MVs of the one
    before, with one half-pel stack: CUDA tensors -> one launch of
    ``hl_refine_subpel``; CPU tensors -> the twin's chain.  ``hp`` is
    ``halfpel_planes(ref_pad)`` (4, Hp, Wp), or (S, 4, Hp, Wp) of which
    slot 0 is read, as the twin does; computed here where it is None.
    The kernel takes steps of at most ``RF_MAX_STEP`` quarter-pels.
    Returns the last round's (mv_blk, per-partition cost)."""
    if not 1 <= len(steps) <= 2:
        raise ValueError(f"refine_subpel_rounds_fast: {len(steps)} steps; "
                         "it runs one or two")
    device = _device("refine_subpel_rounds_fast",
                     (src_pad, ref_pad, mv_blk, part_of_blk))
    if hp is None:
        hp = halfpel_planes(ref_pad)
    if device is None:
        for step in steps:
            mv_blk, cost = refine_subpel(
                src_pad, ref_pad, mv_blk, part_of_blk, lam_motion, step,
                gw=gw, gh=gh, nparts=nparts, use_satd=use_satd, hp=hp)
        return mv_blk, cost
    global REFINE_LAUNCHES
    from hartallo_tpu_torch import kernels
    name = "refine_subpel_rounds_fast"
    if not 1 <= nparts <= 16:
        raise ValueError(f"{name}: nparts {nparts} outside [1, 16]")
    if any(abs(s) > RF_MAX_STEP for s in steps):
        raise ValueError(f"{name}: steps {tuple(steps)}; the kernel stages "
                         f"windows for steps up to {RF_MAX_STEP}")
    H, W = gh * 16, gw * 16
    _plane(src_pad, PAD + H, PAD + W, f"{name}: src_pad")
    if hp.dtype != torch.int32 or not hp.is_contiguous() or \
            hp.dim() not in (3, 4) or hp.shape[-3] != 4 or \
            hp.shape[-2] < H + 2 * PAD - 2 or hp.shape[-1] < W + 2 * PAD - 2 \
            or hp.device != device:
        raise ValueError(f"{name}: hp {hp.dtype} {tuple(hp.shape)} on "
                         f"{hp.device}; it needs int32, contiguous, "
                         f"([S,] 4, Hp, Wp) with Hp >= {H + 2 * PAD - 2} and "
                         f"Wp >= {W + 2 * PAD - 2} on {device}")
    _map(mv_blk, (gh, gw, 16, 2), f"{name}: mv_blk")
    _map(part_of_blk, (gh, gw, 16), f"{name}: part_of_blk")
    lam = _lam(lam_motion, device)
    mv_out = torch.empty_like(mv_blk)
    cost = torch.empty((gh, gw, nparts), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        rc = kernels.load().hl_refine_subpel(
            src_pad.data_ptr(), hp.data_ptr(), mv_blk.data_ptr(),
            part_of_blk.data_ptr(), lam.data_ptr(), mv_out.data_ptr(),
            cost.data_ptr(), src_pad.stride(0), hp.shape[-2], hp.shape[-1],
            gw, gh, nparts, len(steps), int(steps[0]), int(steps[-1]),
            int(bool(use_satd)),
            torch.cuda.current_stream(device).cuda_stream)
    _check(rc, "hl_refine_subpel")
    REFINE_LAUNCHES += 1
    return mv_out, cost


def refine_subpel_fast(src_pad, ref_pad, mv_blk, part_of_blk, lam_motion,
                       step_qpel: int, *, gw: int, gh: int, nparts: int,
                       use_satd: bool = True, hp=None):
    """``refine_subpel``, one round: CUDA tensors -> ``hl_refine_subpel``
    with one step; CPU tensors -> the plain twin."""
    return refine_subpel_rounds_fast(
        src_pad, ref_pad, mv_blk, part_of_blk, lam_motion,
        (int(step_qpel),), gw=gw, gh=gh, nparts=nparts, use_satd=use_satd,
        hp=hp)
