"""SVC inter-layer resampling (spec G.8.6.2, G.8.6.3) for the port.

The numpy helpers (``ref_positions``, ``upsample_plane_np``,
``upsample_residual_plane_np``, ``downsample_dyadic_np``) and the Table
G-9 filters are copies of ``hartallo_tpu/svc/upsample.py``, whose module
imports jax.  ``upsample_plane`` is the port of its batched jnp
upsampler: one whole-plane pass of per-output-sample 4-tap (luma) or
2-tap (chroma) gathers from the clamped base plane, vertical then
horizontal, intermediate sums unrounded, final clip((acc + 512) >> 10).

Reference parity: ``hl_codec_264_decode_svc.c:2817-2926``
(_resample_intra -> _interpol_intra_base) with the Table G-9 filters
(``hl_codec_264_tables.h:626,647``).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

# Table G-9: 16-phase 4-tap luma filter.
PHASE_LUMA = np.array(
    [[0, 32, 0, 0], [-1, 32, 2, -1], [-2, 31, 4, -1], [-3, 30, 6, -1],
     [-3, 28, 8, -1], [-4, 26, 11, -1], [-4, 24, 14, -2], [-3, 22, 16, -3],
     [-3, 19, 19, -3], [-3, 16, 22, -3], [-2, 14, 24, -4], [-1, 11, 26, -4],
     [-1, 8, 28, -3], [-1, 6, 30, -3], [-1, 4, 31, -2], [-1, 2, 32, -1]],
    dtype=np.int32)
# 16-phase 2-tap (bilinear) chroma filter.
PHASE_CHROMA = np.array([[32 - 2 * p, 2 * p] for p in range(16)],
                        dtype=np.int32)


def ref_positions(out_size: int, ref_size: int, chroma: bool = False,
                  phase: int = -1, ref_phase: int = -1):
    """1/16-pel reference positions per output sample — the exact G.6.3
    derivation (G-45..G-59) for progressive frames with zero scaled-ref
    offsets and level_idc <= 30 (shift 16).  ``phase``/``ref_phase`` are
    chroma_phase_*_plus1 - 1 (both default -1 when the flags are absent);
    for luma the (2 + 0) variant with delta 8 applies.

    Returns (base_idx, phase16): sample index of the filter tap x=1 (the
    "left" integer sample) and the 0..15 phase."""
    shift = 16
    scale = ((ref_size << shift) + (out_size >> 1)) // out_size   # G-45
    if chroma:
        add = (((ref_size * (2 + phase)) << (shift - 2)) +
               (out_size >> 1)) // out_size + (1 << (shift - 5))  # G-48
        delta = 4 * (2 + ref_phase)                               # G-49
    else:
        add = (((ref_size * 2) << (shift - 2)) +
               (out_size >> 1)) // out_size + (1 << (shift - 5))
        delta = 8
    x = np.arange(out_size, dtype=np.int64)
    pos16 = ((x * scale + add) >> (shift - 4)) - delta            # G-59
    base = pos16 >> 4
    phase16 = (pos16 & 15).astype(np.int64)
    return base.astype(np.int64), phase16


def upsample_plane_np(base: np.ndarray, out_h: int, out_w: int,
                      chroma: bool = False) -> np.ndarray:
    """NumPy oracle: separable 16-phase upsampling with edge clamping."""
    filt = PHASE_CHROMA if chroma else PHASE_LUMA
    taps = filt.shape[1]
    off = 1 if taps == 4 else 0          # tap index of the base sample
    h, w = base.shape
    bx, px = ref_positions(out_w, w, chroma)
    by, py = ref_positions(out_h, h, chroma)
    # vertical first: (h_out, w) intermediate, unrounded
    tmp = np.zeros((out_h, w), dtype=np.int64)
    for yo in range(out_h):
        acc = np.zeros(w, dtype=np.int64)
        for k in range(taps):
            yy = int(np.clip(by[yo] + k - off, 0, h - 1))
            acc += int(filt[py[yo], k]) * base[yy, :].astype(np.int64)
        tmp[yo] = acc
    out = np.zeros((out_h, out_w), dtype=np.int32)
    for xo in range(out_w):
        acc = np.zeros(out_h, dtype=np.int64)
        for k in range(taps):
            xx = int(np.clip(bx[xo] + k - off, 0, w - 1))
            acc += int(filt[px[xo], k]) * tmp[:, xx]
        out[:, xo] = np.clip((acc + 512) >> 10, 0, 255)
    return out


@lru_cache(maxsize=None)
def _taps(out_size: int, ref_size: int, chroma: bool, device):
    """Per output sample and tap, the clamped source index and the filter
    weight, each (taps, out_size) int64 / int32 on ``device``: made once
    per geometry and device.  Shared: never written."""
    filt = PHASE_CHROMA if chroma else PHASE_LUMA
    taps = filt.shape[1]
    off = 1 if taps == 4 else 0
    b, p = ref_positions(out_size, ref_size, chroma)
    idx = np.stack([np.clip(b + k - off, 0, ref_size - 1)
                    for k in range(taps)])
    wt = np.stack([filt[p, k] for k in range(taps)])
    return (torch.as_tensor(idx, dtype=torch.int64, device=device),
            torch.as_tensor(wt, dtype=torch.int32, device=device))


def upsample_plane(base: torch.Tensor, out_h: int, out_w: int,
                   chroma: bool = False) -> torch.Tensor:
    """Batched torch upsampling (same semantics as the oracle) on the
    base plane's device.  int32 accumulators are exact: 8-bit samples
    through two 16-phase passes bound the accumulator by
    255 * 32 * 32 < 2^19."""
    h, w = base.shape
    basei = base.to(torch.int32)
    rows, wy = _taps(out_h, h, chroma, base.device)
    cols, wx = _taps(out_w, w, chroma, base.device)
    tmp = sum(wy[k][:, None] * basei[rows[k], :] for k in range(len(rows)))
    out = sum(wx[k][None, :] * tmp[:, cols[k]] for k in range(len(cols)))
    return torch.clamp((out + 512) >> 10, 0, 255)


def upsample_residual_plane_np(res: np.ndarray, out_h: int, out_w: int,
                               chroma: bool = False) -> np.ndarray:
    """G.8.6.3 residual resampling: block-edge-constrained bilinear
    interpolation of the reference layer's residual array (spec
    G-334..G-342; reference ``_hl_codec_264_decode_svc_residual_interpol``
    at ``hl_codec_264_decode_svc.c:3400-3460``).  Bilinear within one
    4x4 transform block, nearest-sample across block edges.  The
    transform-block map is the uniform 4x4 grid (this codec codes every
    residual with the 4x4 transform; intra reference MBs contribute
    zero residual via the rS re-initialisation in d_pool).
    """
    h, w = res.shape
    bx, px = ref_positions(out_w, w, chroma)
    by, py = ref_positions(out_h, h, chroma)
    x0 = np.clip(bx, 0, w - 1)
    x1 = np.clip(bx + 1, 0, w - 1)
    y0 = np.clip(by, 0, h - 1)
    y1 = np.clip(by + 1, 0, h - 1)
    same_x = ((x0 >> 2) == (x1 >> 2))[None, :]
    same_y = ((y0 >> 2) == (y1 >> 2))[:, None]
    r = res.astype(np.int64)

    def hpass(rows):
        s0 = r[rows][:, x0]
        s1 = r[rows][:, x1]
        lin = (16 - px)[None, :] * s0 + px[None, :] * s1     # G-339
        near = np.where(px[None, :] < 8, s0, s1) << 4        # G-340
        return np.where(same_x, lin, near)

    t0 = hpass(y0)
    t1 = hpass(y1)
    lin = ((16 - py)[:, None] * t0 + py[:, None] * t1 + 128) >> 8  # G-341
    near = (np.where(py[:, None] < 8, t0, t1) + 8) >> 4            # G-342
    return np.where(same_y, lin, near).astype(np.int32)


def downsample_dyadic_np(plane: np.ndarray) -> np.ndarray:
    """Simple 2x downsampler for the encoder's layer source generation
    (JSVM uses an 11-tap; a [1,2,1]x[1,2,1]/16 kernel is adequate for
    source preparation — this is an encoder-side choice, not normative)."""
    p = np.pad(plane.astype(np.int32), 1, mode="edge")
    core = (p[:-2, :] + 2 * p[1:-1, :] + p[2:, :])
    core = (core[:, :-2] + 2 * core[:, 1:-1] + core[:, 2:])
    full = (core + 8) >> 4
    return full[::2, ::2].astype(plane.dtype)
