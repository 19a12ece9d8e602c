"""Intra prediction banks on torch tensors (spec 8.3.1 - 8.3.4).

Port of ``hartallo_tpu/ops/intra.py``.  Every directional Intra4x4 mode is
a per-pixel weighted sum of at most three samples of the 13-sample edge
vector ``s = [l3, l2, l1, l0, tl, t0, ..., t7]``; the (index, weight,
round, shift) tables are built once in numpy from the spec formulas, and
the bank is one gather and a multiply-add.  DC and Plane modes are
computed directly.  All math is int32.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def _si_l(i):          # s-index of left[i]
    return 3 - i


def _si_t(i):          # s-index of top[i]
    return 5 + i


_SI_TL = 4

# modes handled by the gather bank, in bank-row order
GATHER_MODES = (0, 1, 3, 4, 5, 6, 7, 8)


def _mode_tables():
    idx = np.zeros((8, 4, 4, 3), dtype=np.int32)
    wgt = np.zeros((8, 4, 4, 3), dtype=np.int32)
    rnd = np.zeros((8, 4, 4), dtype=np.int32)
    sht = np.zeros((8, 4, 4), dtype=np.int32)

    def put(m, y, x, terms, r, s):
        for k, (i, w) in enumerate(terms):
            idx[m, y, x, k] = i
            wgt[m, y, x, k] = w
        rnd[m, y, x] = r
        sht[m, y, x] = s

    for y in range(4):
        for x in range(4):
            put(0, y, x, [(_si_t(x), 1)], 0, 0)            # vertical
            put(1, y, x, [(_si_l(y), 1)], 0, 0)            # horizontal
            if x == 3 and y == 3:                          # diag down-left
                put(2, y, x, [(_si_t(6), 1), (_si_t(7), 3)], 2, 2)
            else:
                put(2, y, x, [(_si_t(x + y), 1), (_si_t(x + y + 1), 2),
                              (_si_t(x + y + 2), 1)], 2, 2)
            if x > y:                                      # diag down-right
                put(3, y, x, [(_si_t(x - y - 2), 1), (_si_t(x - y - 1), 2),
                              (_si_t(x - y), 1)], 2, 2)
            elif x < y:
                put(3, y, x, [(_si_l(y - x - 2), 1), (_si_l(y - x - 1), 2),
                              (_si_l(y - x), 1)], 2, 2)
            else:
                put(3, y, x, [(_si_t(0), 1), (_SI_TL, 2), (_si_l(0), 1)],
                    2, 2)
            z = 2 * x - y                                  # vertical right
            if z >= 0 and z % 2 == 0:
                put(4, y, x, [(_si_t(x - (y >> 1) - 1), 1),
                              (_si_t(x - (y >> 1)), 1)], 1, 1)
            elif z >= 0:
                put(4, y, x, [(_si_t(x - (y >> 1) - 2), 1),
                              (_si_t(x - (y >> 1) - 1), 2),
                              (_si_t(x - (y >> 1)), 1)], 2, 2)
            elif z == -1:
                put(4, y, x, [(_si_l(0), 1), (_SI_TL, 2), (_si_t(0), 1)],
                    2, 2)
            else:
                put(4, y, x, [(_si_l(y - 1), 1), (_si_l(y - 2), 2),
                              (_si_l(y - 3), 1)], 2, 2)
            z = 2 * y - x                                  # horizontal down
            if z >= 0 and z % 2 == 0:
                put(5, y, x, [(_si_l(y - (x >> 1) - 1), 1),
                              (_si_l(y - (x >> 1)), 1)], 1, 1)
            elif z >= 0:
                put(5, y, x, [(_si_l(y - (x >> 1) - 2), 1),
                              (_si_l(y - (x >> 1) - 1), 2),
                              (_si_l(y - (x >> 1)), 1)], 2, 2)
            elif z == -1:
                put(5, y, x, [(_si_t(0), 1), (_SI_TL, 2), (_si_l(0), 1)],
                    2, 2)
            else:
                put(5, y, x, [(_si_t(x - 1), 1), (_si_t(x - 2), 2),
                              (_si_t(x - 3), 1)], 2, 2)
            if y % 2 == 0:                                 # vertical left
                put(6, y, x, [(_si_t(x + (y >> 1)), 1),
                              (_si_t(x + (y >> 1) + 1), 1)], 1, 1)
            else:
                put(6, y, x, [(_si_t(x + (y >> 1)), 1),
                              (_si_t(x + (y >> 1) + 1), 2),
                              (_si_t(x + (y >> 1) + 2), 1)], 2, 2)
            z = x + 2 * y                                  # horizontal up
            if z < 5 and z % 2 == 0:
                put(7, y, x, [(_si_l(y + (x >> 1)), 1),
                              (_si_l(y + (x >> 1) + 1), 1)], 1, 1)
            elif z < 5:
                put(7, y, x, [(_si_l(y + (x >> 1)), 1),
                              (_si_l(y + (x >> 1) + 1), 2),
                              (_si_l(y + (x >> 1) + 2), 1)], 2, 2)
            elif z == 5:
                put(7, y, x, [(_si_l(2), 1), (_si_l(3), 3)], 2, 2)
            else:
                put(7, y, x, [(_si_l(3), 1)], 0, 0)
    return idx, wgt, rnd, sht


_IDX, _WGT, _RND, _SHT = _mode_tables()


@lru_cache(maxsize=None)
def _mode_bank(device):
    """(index int64, weight, round, shift) tables on ``device``, made once
    per device.  Shared: never written."""
    return (torch.as_tensor(_IDX, dtype=torch.long, device=device),
            torch.as_tensor(_WGT, device=device),
            torch.as_tensor(_RND, device=device),
            torch.as_tensor(_SHT, device=device))


def _dc(at, al, tsum, lsum, both_sh, one_sh):
    """DC rule shared by the three banks: the average of the available
    edges, 128 when neither is available."""
    both = (tsum + lsum + (1 << (both_sh - 1))) >> both_sh
    return torch.where(at & al, both,
                       torch.where(al, (lsum + (1 << (one_sh - 1))) >> one_sh,
                                   torch.where(at, (tsum + (1 << (one_sh - 1)))
                                               >> one_sh, 128)))


def _flag(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.bool, device=like.device)


def pred4x4_all(top, left, tl, avail_top, avail_left) -> torch.Tensor:
    """All 9 Intra4x4 modes; top (..., 8) with the top-right already
    substituted, left (..., 4), tl (...,).  Returns (..., 9, 4, 4)."""
    idx, wgt, rnd, sht = _mode_bank(top.device)
    s = torch.cat([left.flip(-1), tl[..., None], top], dim=-1) \
        .to(torch.int32)
    bank = ((s[..., idx] * wgt).sum(-1) + rnd) >> sht
    tsum = top[..., :4].to(torch.int32).sum(-1)
    lsum = left.to(torch.int32).sum(-1)
    dc = _dc(_flag(avail_top, top), _flag(avail_left, top), tsum, lsum, 3, 2)
    dc = dc[..., None, None, None].expand(*dc.shape, 1, 4, 4).to(torch.int32)
    return torch.cat([bank[..., 0:2, :, :], dc, bank[..., 2:, :, :]], dim=-3)


def _plane(t, l, tl, n: int, mul: int, rnd: int, sh: int):
    """Plane mode of an n x n block (16 for luma, 8 for chroma)."""
    dev = t.device
    h = n // 2
    text = torch.cat([tl[..., None], t], dim=-1)           # ext[i]=p[i-1,-1]
    lext = torch.cat([tl[..., None], l], dim=-1)
    xs = torch.arange(h, device=dev)
    H = ((xs + 1) * (t[..., h:] - text[..., h - 1 - xs])).sum(-1)
    V = ((xs + 1) * (l[..., h:] - lext[..., h - 1 - xs])).sum(-1)
    a = 16 * (l[..., n - 1] + t[..., n - 1])
    b = (mul * H + rnd) >> sh
    c = (mul * V + rnd) >> sh
    gx = torch.arange(n, device=dev) - (h - 1)
    gy = gx[:, None]
    return torch.clamp((a[..., None, None] + b[..., None, None] * gx +
                        c[..., None, None] * gy + 16) >> 5, 0, 255)


def pred16x16_all(top, left, tl, avail_top, avail_left) -> torch.Tensor:
    """All 4 Intra16x16 modes (V, H, DC, Plane); returns (..., 4, 16, 16)."""
    t = top.to(torch.int32)
    l = left.to(torch.int32)
    batch = t.shape[:-1]
    v = t[..., None, :].expand(*batch, 16, 16)
    h = l[..., :, None].expand(*batch, 16, 16)
    dcv = _dc(_flag(avail_top, t), _flag(avail_left, t), t.sum(-1),
              l.sum(-1), 5, 4)
    dc = dcv[..., None, None].expand(*batch, 16, 16).to(torch.int32)
    plane = _plane(t, l, tl.to(torch.int32), 16, 5, 32, 6)
    return torch.stack([v, h, dc, plane], dim=-3)


def pred_chroma_all(top, left, tl, avail_top, avail_left) -> torch.Tensor:
    """All 4 chroma modes (DC, H, V, Plane); returns (..., 4, 8, 8)."""
    t = top.to(torch.int32)
    l = left.to(torch.int32)
    batch = t.shape[:-1]
    at = _flag(avail_top, t)
    al = _flag(avail_left, t)
    ts0, ts1 = t[..., 0:4].sum(-1), t[..., 4:8].sum(-1)
    ls0, ls1 = l[..., 0:4].sum(-1), l[..., 4:8].sum(-1)
    v00 = _dc(at, al, ts0, ls0, 3, 2)
    v11 = _dc(at, al, ts1, ls1, 3, 2)
    # the off-diagonal corners prefer one edge: (x=4..7, y=0..3) the top,
    # (x=0..3, y=4..7) the left
    v10 = torch.where(at, (ts1 + 2) >> 2,
                      torch.where(al, (ls0 + 2) >> 2, 128))
    v01 = torch.where(al, (ls1 + 2) >> 2,
                      torch.where(at, (ts0 + 2) >> 2, 128))
    q = torch.stack([torch.stack([v00, v10], dim=-1),
                     torch.stack([v01, v11], dim=-1)], dim=-2)
    dc = q.repeat_interleave(4, -2).repeat_interleave(4, -1) \
        .to(torch.int32)
    h = l[..., :, None].expand(*batch, 8, 8)
    v = t[..., None, :].expand(*batch, 8, 8)
    plane = _plane(t, l, tl.to(torch.int32), 8, 17, 16, 5)
    return torch.stack([dc, h, v, plane], dim=-3)
