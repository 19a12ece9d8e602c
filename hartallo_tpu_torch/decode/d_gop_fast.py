"""Whole-GOP decode of kernel-eligible pictures: the CUDA kernel and its
plain torch twin.

Counterpart of ``hartallo_tpu/decode/d_gop_pallas.py`` (``decode_gop_pl``).
``decode_gop_fast`` takes the same payload, made on the host by
``d_pool.pack_fast`` and stacked by ``stack_payload``:

    smb   (K, nMB, 8) int32    MC window words, 4 luma + 4 chroma quadrants
    aux   (K, gh, gw, 62) int16 per-MB deblock parameters
    sf    (K, 8) int32         [wslot, rslot, nl, nu, nr, n_intra, 0, 0]
    tags  (K, NR) int32        residual 4x4 targets, (y << 12) | x
    vals  (K, NR, 16) int16    residual samples, row-major
    ilist (K, NI, 4) int32     intra MBs [mb, flags, i4 modes 0-7, 8-15]
    ivals (K, NI, 24, 16) int16 intra residual, 16 luma + 4 U + 4 V blocks
    ringY (S, 4, Hr, Wr), ringU/ringV (S, Hcr, Wcr) uint8   DPB ring

and returns ``(out (K, H + H/2, W) uint8, ringY, ringU, ringV)``.  The
ring is state and is updated in place.  On CUDA tensors it launches the
kernel of ``csrc/d_gop.cu``; on CPU tensors it runs
``decode_gop_fast_plain``.  There is no other branch: a failed build or
launch raises.

``stages`` keeps the Pallas kernel's letters, so parity can be checked
stage by stage: m (MC), r (residual), i (intra), w/d/s (skew, deblock,
unskew: the deblock runs when all three are given; skewing is a TPU
layout step with no counterpart here), h (6-tap half-pel planes; without
it the b/h/j planes are rounded copies of G, as in the Pallas kernel) and
o (output, which like the ring write always happens).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from hartallo_tpu_torch.decode.intra_recon import PAD
from hartallo_tpu_torch.ops import intra as _intra
from hartallo_tpu_torch.ops.deblock import NAUX, deblock_filter
from hartallo_tpu_torch.ops.intra import (pred16x16_all, pred4x4_all,
                                          pred_chroma_all)
from hartallo_tpu_torch.ops.wide import _RASTER_TO_BLK, halfpel_planes, \
    pad_edge

SF = 8               # sf words per picture
SI = 4               # ilist words per intra MB
# the kernel's intra schedule holds gw + 2 gh - 2 slope-2 steps and gw gh
# intra MBs in shared memory (1920x1088: 254 and 8160)
MAX_STEPS = 256
MAX_INTRA = 8192

LAUNCHES = 0         # pictures decoded by the CUDA kernel in this process

_BLK_X = [8 * ((b >> 2) & 1) + 4 * (b & 1) for b in range(16)]
_BLK_Y = [8 * (b >> 3) + 4 * ((b >> 1) & 1) for b in range(16)]
_TR_NEVER = (3, 7, 11, 13, 15)
_TR_EDGE_BLK = 5
_STAGE_BITS = (("m", 1), ("r", 2), ("i", 4), ("wds", 8), ("h", 16))


def stage_mask(stages: str) -> int:
    """Stage letters -> the kernel's stage bits."""
    return sum(bit for letters, bit in _STAGE_BITS
               if all(c in stages for c in letters))


# ---------------------------------------------------------------------------
# Host payload
# ---------------------------------------------------------------------------

def stack_payload(frames, nr: int = 0, ni: int = 0):
    """Stack ``d_pool.FastFrame``s (the JAX package's are taken as they
    are) into the batch payload as numpy arrays: dict smb, aux, sf, tags,
    vals, ilist, ivals.  nr/ni: residual-pool and intra-list capacity;
    at least each picture's count (default: the batch maximum, >= 1).
    The Pallas kernel needs the JAX package's capacities (256 or
    ``hartallo_tpu.decode.d_pool.nrmax``, 32 or ``nimax``); the CUDA
    kernel and its twin take any."""
    K = len(frames)
    nr = max(nr, 1, *(f.tags.shape[0] for f in frames))
    ni = max(ni, 1, *(f.ilist.shape[0] for f in frames))
    sf = np.zeros((K, SF), np.int32)
    tags = np.zeros((K, nr), np.int32)
    vals = np.zeros((K, nr, 16), np.int16)
    ilist = np.zeros((K, ni, SI), np.int32)
    ivals = np.zeros((K, ni, 24, 16), np.int16)
    for i, f in enumerate(frames):
        m, n_i = f.tags.shape[0], f.ilist.shape[0]
        sf[i, 0], sf[i, 1] = f.wslot, f.ref_slot
        sf[i, 2:5] = f.counts
        sf[i, 5] = n_i
        tags[i, :m] = f.tags
        vals[i, :m] = f.vals
        ilist[i, :n_i] = f.ilist
        ivals[i, :n_i] = f.ivals
    return {"smb": np.stack([f.smb for f in frames]).astype(np.int32),
            "aux": np.stack([f.aux for f in frames]).astype(np.int16),
            "sf": sf, "tags": tags, "vals": vals, "ilist": ilist,
            "ivals": ivals}


def payload_to(payload, device):
    """numpy payload dict -> tensors on ``device`` (same keys)."""
    return {k: torch.as_tensor(v, device=device) for k, v in payload.items()}


def rings_from_numpy(ringY, ringU, ringV, device):
    """The JAX package's (or any) numpy uint8 rings -> tensors on
    ``device``, copied (the port updates rings in place)."""
    return tuple(torch.tensor(np.asarray(r), dtype=torch.uint8,
                              device=device) for r in (ringY, ringU, ringV))


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def decode_gop_fast(smb, aux, sf, tags, vals, ilist, ivals,
                    ringY, ringU, ringV, *, gw: int, gh: int,
                    stages: str = "mriwdsoh"):
    """Decode K kernel-eligible pictures (payload and result as in the
    module docstring).  CUDA tensors -> the CUDA kernel; CPU tensors ->
    ``decode_gop_fast_plain``."""
    args = (smb, aux, sf, tags, vals, ilist, ivals, ringY, ringU, ringV)
    kinds = {t.device.type for t in args}
    if kinds == {"cpu"}:
        return decode_gop_fast_plain(*args, gw=gw, gh=gh, stages=stages)
    if kinds != {"cuda"}:
        raise ValueError(f"decode_gop_fast: tensors on {sorted(kinds)}; "
                         "all must be on one CUDA device or all on the CPU")
    return _launch(*args, gw=gw, gh=gh, stages=stages)


_DTYPES = {"smb": torch.int32, "aux": torch.int16, "sf": torch.int32,
           "tags": torch.int32, "vals": torch.int16, "ilist": torch.int32,
           "ivals": torch.int16, "ringY": torch.uint8,
           "ringU": torch.uint8, "ringV": torch.uint8}


def _check_payload(named, gw: int, gh: int):
    dev = named["ringY"].device
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, ringY on {dev}")
        if t.dtype != _DTYPES[name]:
            raise TypeError(f"{name} must be {_DTYPES[name]}, not {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    K, nMB = named["smb"].shape[0], gw * gh
    if gw + 2 * gh - 2 > MAX_STEPS or nMB > MAX_INTRA:
        raise ValueError(f"a {gw}x{gh}-MB frame exceeds the intra "
                         f"schedule ({MAX_STEPS} steps, {MAX_INTRA} MBs)")
    NR, NI = named["tags"].shape[1], named["ilist"].shape[1]
    S = named["ringY"].shape[0]
    Hp, Wp = gh * 16 + 2 * PAD, gw * 16 + 2 * PAD
    Hcp, Wcp = gh * 8 + 2 * PAD, gw * 8 + 2 * PAD
    want = {"smb": (K, nMB, 8), "aux": (K, gh, gw, NAUX), "sf": (K, SF),
            "tags": (K, NR), "vals": (K, NR, 16), "ilist": (K, NI, SI),
            "ivals": (K, NI, 24, 16)}
    for name, shape in want.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(named[name].shape)}, "
                             f"expected {shape}")
    rY, rU, rV = named["ringY"], named["ringU"], named["ringV"]
    if rY.dim() != 4 or rY.shape[1] != 4 or rY.shape[2] < Hp or \
            rY.shape[3] < Wp:
        raise ValueError(f"ringY shape {tuple(rY.shape)} too small")
    for r in (rU, rV):
        if r.dim() != 3 or r.shape[0] != S or r.shape[1] < Hcp or \
                r.shape[2] < Wcp:
            raise ValueError(f"chroma ring shape {tuple(r.shape)} too small")
    return K, NR, NI


def _i4tab(device) -> torch.Tensor:
    """The Intra4x4 mode tables as the kernel's int32 [idx|wgt|rnd|sht]."""
    return torch.as_tensor(np.concatenate(
        [_intra._IDX.ravel(), _intra._WGT.ravel(), _intra._RND.ravel(),
         _intra._SHT.ravel()]).astype(np.int32), device=device)


def _launch(smb, aux, sf, tags, vals, ilist, ivals, ringY, ringU, ringV,
            *, gw: int, gh: int, stages: str):
    global LAUNCHES
    from hartallo_tpu_torch import kernels

    named = dict(smb=smb, aux=aux, sf=sf, tags=tags, vals=vals, ilist=ilist,
                 ivals=ivals, ringY=ringY, ringU=ringU, ringV=ringV)
    K, NR, NI = _check_payload(named, gw, gh)
    dev = ringY.device
    H, W = gh * 16, gw * 16
    out = torch.empty((K, H + H // 2, W), dtype=torch.uint8, device=dev)
    py = torch.zeros((H + 2 * PAD, W + 2 * PAD), dtype=torch.int32,
                     device=dev)
    pu = torch.zeros((H // 2 + 2 * PAD, W // 2 + 2 * PAD),
                     dtype=torch.int32, device=dev)
    pv = torch.zeros_like(pu)
    prog = torch.zeros(K * gh, dtype=torch.int32, device=dev)  # deblock rows
    i4tab = _i4tab(dev)
    ptr = [ctypes.c_void_p(t.data_ptr()) for t in
           (smb, aux, sf, tags, vals, ilist, ivals, i4tab, ringY, ringU,
            ringV, out, py, pu, pv, prog)]
    lib = kernels.load()
    with torch.cuda.device(dev):
        rc = lib.hl_decode_gop(
            *ptr, K, gw, gh, NR, NI, ringY.shape[2], ringY.shape[3],
            ringU.shape[1], ringU.shape[2], stage_mask(stages),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"hl_decode_gop: CUDA error {rc} "
                           f"({kernels.error_string(rc)})")
    LAUNCHES += K
    return out, ringY, ringU, ringV


# ---------------------------------------------------------------------------
# Plain torch twin
# ---------------------------------------------------------------------------

def _mc_plain(smb_k, rslot, ringY, ringU, ringV, py, pu, pv, gw, gh):
    dev = smb_k.device
    H, W = gh * 16, gw * 16
    _, _, HrY, WrY = ringY.shape
    w = smb_k[:, :4].to(torch.int64)                        # (nMB, 4)
    d1x, d1y, d0x, d0y = w & 1, (w >> 1) & 1, (w >> 2) & 1, (w >> 3) & 1
    p1, p0 = (w >> 4) & 3, (w >> 6) & 3
    x0, y0 = (w >> 8) & 4095, w >> 20
    r8 = torch.arange(8, device=dev)
    off8 = (r8[:, None] * WrY + r8[None, :])                # (8, 8)
    flatY = ringY.reshape(-1)

    def win(p, dy, dx):
        base = ((rslot * 4 + p) * HrY + y0 + dy) * WrY + x0 + dx
        return torch.take(flatY, base[..., None, None] + off8) \
            .to(torch.int32)                                # (nMB, 4, 8, 8)

    pred = (win(p0, d0y, d0x) + win(p1, d1y, d1x) + 1) >> 1
    py[PAD:PAD + H, PAD:PAD + W] = pred.reshape(gh, gw, 2, 2, 8, 8) \
        .permute(0, 2, 4, 1, 3, 5).reshape(H, W)

    _, HrC, WrC = ringU.shape
    wc = smb_k[:, 4:].to(torch.int64)
    fx = (wc & 7).to(torch.int32)[..., None, None]
    fy = ((wc >> 3) & 7).to(torch.int32)[..., None, None]
    base = (rslot * HrC + (wc >> 17)) * WrC + ((wc >> 6) & 2047)
    r4 = torch.arange(4, device=dev)
    idx = base[..., None, None] + r4[:, None] * WrC + r4[None, :]
    for ring, plane in ((ringU, pu), (ringV, pv)):
        flat = ring.reshape(-1)

        def tap(o):
            return torch.take(flat, idx + o).to(torch.int32)

        v = ((8 - fx) * (8 - fy) * tap(0) + fx * (8 - fy) * tap(1) +
             (8 - fx) * fy * tap(WrC) + fx * fy * tap(WrC + 1) + 32) >> 6
        plane[PAD:PAD + gh * 8, PAD:PAD + gw * 8] = \
            v.reshape(gh, gw, 2, 2, 4, 4).permute(0, 2, 4, 1, 3, 5) \
            .reshape(gh * 8, gw * 8)


def _res_plain(tags_k, vals_k, counts, py, pu, pv):
    nl, nu, nr = counts
    dev = tags_k.device
    r4 = torch.arange(4, device=dev)
    for lo, hi, plane in ((0, nl, py), (nl, nu, pu), (nu, nr, pv)):
        if hi <= lo:
            continue
        tag = tags_k[lo:hi].to(torch.int64)
        rows = ((tag >> 12)[:, None] + r4)[:, :, None]      # (n, 4, 1)
        cols = ((tag & 4095)[:, None] + r4)[:, None, :]     # (n, 1, 4)
        add = vals_k[lo:hi].to(torch.int32).reshape(-1, 4, 4)
        plane[rows, cols] = torch.clamp(plane[rows, cols] + add, 0, 255)


def _blocks_to_tile(blocks: torch.Tensor, n: int) -> torch.Tensor:
    """(n*n/16 blocks, 16) row-major 4x4 blocks in raster order ->
    (n, n) tile."""
    q = n // 4
    return blocks.reshape(q, q, 4, 4).permute(0, 2, 1, 3).reshape(n, n)


def intra_step(m: int, gw: int) -> int:
    """The slope-2 step t = mx + 2 my of MB address m, the CUDA kernel's
    ``step_of``: it runs the intra MBs of one step at once, in no fixed
    order, and the steps in order.  An intra MB reads its left, top,
    top-left and top-right neighbours, all of lower steps."""
    return m % gw + 2 * (m // gw)


def _intra_plain(ilist_k, ivals_k, n_imb, py, pu, pv, gw, order=None):
    """Intra MBs on the work planes, one MB at a time, in raster order
    (the list's order, the reference) or in ``order`` (list positions)."""
    rows = ilist_k[:n_imb].cpu().tolist()
    raster = torch.as_tensor(_RASTER_TO_BLK, device=py.device)
    for i in range(n_imb) if order is None else order:
        m, w, i4a, i4b = rows[i]
        my, mx = divmod(m, gw)
        is16, i16m, cmode = w & 1, (w >> 1) & 3, (w >> 3) & 3
        alf, atf, atrf = bool((w >> 5) & 1), bool((w >> 6) & 1), \
            bool((w >> 7) & 1)
        y0p, x0p = PAD + my * 16, PAD + mx * 16
        rv = ivals_k[i].to(torch.int32)                     # (24, 16)
        if not is16:
            for b in range(16):
                by, bx = _BLK_Y[b], _BLK_X[b]
                yb, xb = y0p + by, x0p + bx
                top = py[yb - 1, xb:xb + 8].clone()
                if b in _TR_NEVER or (b == _TR_EDGE_BLK and
                                      (mx == gw - 1 or not atrf)):
                    top[4:] = top[3]
                mode = (((i4a if b < 8 else i4b) & 0xFFFFFFFF)
                        >> (4 * (b % 8))) & 15
                pred = pred4x4_all(top, py[yb:yb + 4, xb - 1],
                                   py[yb - 1, xb - 1],
                                   atf if by == 0 else True,
                                   alf if bx == 0 else True)[mode]
                py[yb:yb + 4, xb:xb + 4] = \
                    torch.clamp(pred + rv[b].reshape(4, 4), 0, 255)
        else:
            pred = pred16x16_all(py[y0p - 1, x0p:x0p + 16],
                                 py[y0p:y0p + 16, x0p - 1],
                                 py[y0p - 1, x0p - 1], atf, alf)[i16m]
            res = _blocks_to_tile(rv[:16][raster], 16)
            py[y0p:y0p + 16, x0p:x0p + 16] = torch.clamp(pred + res, 0, 255)
        y0c, x0c = PAD + my * 8, PAD + mx * 8
        for pl, plane in ((0, pu), (1, pv)):
            pred = pred_chroma_all(plane[y0c - 1, x0c:x0c + 8],
                                   plane[y0c:y0c + 8, x0c - 1],
                                   plane[y0c - 1, x0c - 1], atf, alf)[cmode]
            res = _blocks_to_tile(rv[16 + 4 * pl:20 + 4 * pl], 8)
            plane[y0c:y0c + 8, x0c:x0c + 8] = torch.clamp(pred + res, 0, 255)


def decode_gop_fast_plain(smb, aux, sf, tags, vals, ilist, ivals,
                          ringY, ringU, ringV, *, gw: int, gh: int,
                          stages: str = "mriwdsoh"):
    """Plain torch version of the kernel: same payload, same result, same
    in-place ring update, on the tensors' device.  MC gathers from the
    ring by the decoded words, the residual is an indexed add, intra is a
    per-MB loop on ``ops/intra`` predictions, deblock is
    ``ops/deblock.deblock_filter`` over ``aux`` and the half-pel planes
    are ``ops/wide.halfpel_planes``."""
    dev = ringY.device
    K = smb.shape[0]
    H, W, Hc, Wc = gh * 16, gw * 16, gh * 8, gw * 8
    Hp, Wp, Hcp, Wcp = H + 2 * PAD, W + 2 * PAD, Hc + 2 * PAD, Wc + 2 * PAD
    py = torch.zeros((Hp, Wp), dtype=torch.int32, device=dev)
    pu = torch.zeros((Hcp, Wcp), dtype=torch.int32, device=dev)
    pv = torch.zeros_like(pu)
    out = torch.empty((K, H + Hc, W), dtype=torch.uint8, device=dev)
    mask = stage_mask(stages)
    sf_h = sf.cpu().tolist()
    for k in range(K):
        wslot, rslot, nl, nu, nr, n_imb = sf_h[k][:6]
        if mask & 1:
            _mc_plain(smb[k], rslot, ringY, ringU, ringV, py, pu, pv, gw, gh)
        if mask & 2:
            _res_plain(tags[k], vals[k], (nl, nu, nr), py, pu, pv)
        if mask & 4:
            _intra_plain(ilist[k], ivals[k], n_imb, py, pu, pv, gw)
        if mask & 8:
            deblock_filter((py, pu, pv), aux[k], gw=gw, gh=gh)
        G = pad_edge(py[PAD:PAD + H, PAD:PAD + W])
        if mask & 16:
            hp = halfpel_planes(G)
        else:
            half = torch.clamp((G + 16) >> 5, 0, 255)
            hp = torch.stack([G, half, half,
                              torch.clamp((G + 512) >> 10, 0, 255)])
        ringY[wslot, :, :Hp, :Wp] = hp.to(torch.uint8)
        for ring, plane in ((ringU, pu), (ringV, pv)):
            ring[wslot, :Hcp, :Wcp] = \
                pad_edge(plane[PAD:PAD + Hc, PAD:PAD + Wc]).to(torch.uint8)
        out[k, :H] = py[PAD:PAD + H, PAD:PAD + W].to(torch.uint8)
        out[k, H:, :Wc] = pu[PAD:PAD + Hc, PAD:PAD + Wc].to(torch.uint8)
        out[k, H:, Wc:] = pv[PAD:PAD + Hc, PAD:PAD + Wc].to(torch.uint8)
    return out, ringY, ringU, ringV
