"""Skewed-diagonal wavefront layout on torch tensors.

Port of ``hartallo_tpu/ops/wavefront.py``.  MB tiles are stored as
``T[d, k]`` with ``d = mx + 2*my`` (``skew_geometry``, the intra
wavefront) or ``d = mx + my`` (``skew1_geometry``, deblocking) and
``k = my``, so one wavefront step is one row of the tensor and its
neighbours live in the rows before it.  The geometry is host numpy; the
gathers run on the tensors' device.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def _geometry(gw: int, gh: int, slope: int):
    D = gw + slope * gh - 1
    K = gh
    my_of = np.zeros((D, K), np.int64)
    mx_of = np.zeros((D, K), np.int64)
    valid = np.zeros((D, K), bool)
    for d in range(D):
        for k in range(K):
            mx = d - slope * k
            if 0 <= mx < gw:
                my_of[d, k] = k
                mx_of[d, k] = mx
                valid[d, k] = True
    my_g, mx_g = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    return {"D": D, "K": K, "my_of": my_of, "mx_of": mx_of,
            "valid": valid, "d_of": (mx_g + slope * my_g).astype(np.int64),
            "k_of": my_g.astype(np.int64)}


@lru_cache(maxsize=None)
def skew_geometry(gw: int, gh: int):
    """Slope-2 index maps (intra: left/top/top-right deps): D = gw + 2gh - 1
    diagonals, K = gh slots; numpy arrays my_of/mx_of/valid (D, K) and
    d_of/k_of (gh, gw)."""
    return _geometry(gw, gh, 2)


@lru_cache(maxsize=None)
def skew1_geometry(gw: int, gh: int):
    """Slope-1 index maps (deblocking: left/top deps): D = gw + gh - 1."""
    return _geometry(gw, gh, 1)


def on_device(geo, name: str, device) -> torch.Tensor:
    """geo[name] as a tensor on ``device``, made once per geometry and
    device and kept in ``geo`` (so that a wavefront makes no host-to-
    device copy after its first run).  Shared: never written."""
    key = (name, torch.device(device))
    if key not in geo:
        geo[key] = torch.as_tensor(geo[name], device=device)
    return geo[key]


def skew(arr: torch.Tensor, geo) -> torch.Tensor:
    """Per-MB (gh, gw, ...) -> skewed (D, K, ...).  Invalid slots hold the
    (0, 0) MB's value; mask with geo['valid'] where it matters."""
    dev = arr.device
    return arr[on_device(geo, "my_of", dev), on_device(geo, "mx_of", dev)]


def unskew(skewed: torch.Tensor, geo) -> torch.Tensor:
    """Skewed (D, K, ...) -> per-MB (gh, gw, ...)."""
    dev = skewed.device
    return skewed[on_device(geo, "d_of", dev), on_device(geo, "k_of", dev)]


def plane_to_tiles(plane: torch.Tensor, size: int) -> torch.Tensor:
    """(gh*size, gw*size) -> (gh, gw, size, size)."""
    H, W = plane.shape
    return plane.reshape(H // size, size, W // size, size) \
        .permute(0, 2, 1, 3)


def tiles_to_plane(tiles: torch.Tensor) -> torch.Tensor:
    """(gh, gw, size, size) -> (gh*size, gw*size)."""
    gh, gw, s, _ = tiles.shape
    return tiles.permute(0, 2, 1, 3).reshape(gh * s, gw * s)


def shift_k(row: torch.Tensor, fill: int = 0) -> torch.Tensor:
    """row[k] -> row[k-1] along dim 0 (slot k reads what was at k-1)."""
    return torch.cat([torch.full_like(row[:1], fill), row[:-1]], dim=0)


def unshift_k(row: torch.Tensor, fill: int = 0) -> torch.Tensor:
    """Inverse scatter of shift_k: values destined for slot k-1 move
    back."""
    return torch.cat([row[1:], torch.full_like(row[:1], fill)], dim=0)
