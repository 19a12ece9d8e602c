"""Host-side compact payload of the whole-GOP decode kernel.

Copy of ``hartallo_tpu/decode/d_pool.py`` (pure numpy) that takes the
quarter-pel case table ``_QPT`` from the port's ``ops/wide.py``, since
the JAX package's ``ops/wide.py`` imports jax.  The JAX package's
``pack_fast`` is ``pack_fast_py`` here, unchanged; ``pack_fast`` builds
the same bytes in one native C pass (``native/packc.c``).  The Pallas
kernel's static capacities are dropped: the batch
cap ``kmax`` (a TPU scalar-memory limit), the intra-list capacity
``nimax`` (its SMEM list) and the residual-pool capacity ``nrmax``.  The
CUDA kernel and its twin take each batch's own intra and residual
counts, so ``eligible`` keeps every rule of the JAX package's but the
intra count, and every 720p and 1080p IDR picture takes the kernel.  The
SVC residual helpers of the general decode path and the SVC encoder,
``accumulated_residual_planes_np`` and ``residual_planes_np``, are
copied unchanged.

The payload per picture:

- ``smb``: per MB, 4 luma + 4 chroma quadrant MC window words;
- ``aux``: per MB deblock thresholds and boundary strengths;
- a residual pool: only the nonzero 4x4 inter residual blocks, as final
  spatial-domain int16 values (dequant + inverse transform on the host,
  bit-identical to ``ops/transform.py``), with packed target tags;
- an intra MB list with each MB's dense residual.

Reference parity: the pooled residual mirrors the reference's sparse
block scan (``hl_codec_264_residual.c:47-280``); window derivation
mirrors ``hl_codec_264_pred_inter.c:300-887`` clamped index maps;
boundary-strength inputs per 8.7.2.1.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from hartallo_tpu_torch import tracing
from hartallo_tpu_torch.core import tables as T
from hartallo_tpu_torch.core.tables import (DEBLOCK_ALPHA, DEBLOCK_BETA,
                                            DEBLOCK_TC0, LUMA_4x4_BLK_XY,
                                            QP_SCALE_CHROMA)
from hartallo_tpu_torch.native import pack as native_pack

PAD = 32
MAX_RES = 16000          # |residual| bound for int16 work planes

_BLK_X = LUMA_4x4_BLK_XY[:, 0].astype(np.int64)      # pixel offsets in MB
_BLK_Y = LUMA_4x4_BLK_XY[:, 1].astype(np.int64)
# blkIdx -> raster 4x4 position (for the Intra16x16 DC scatter)
_BLK_RASTER_OF = ((_BLK_Y // 4) * 4 + _BLK_X // 4).astype(np.int64)


# ---------------------------------------------------------------------------
# numpy mirrors of ops/transform.py (int32-exact)
# ---------------------------------------------------------------------------

def _dequant_np(c: np.ndarray, qp: np.ndarray) -> np.ndarray:
    """8.5.12.1 flat dequant; c (...,4,4) int32, qp (...,)."""
    c = c.astype(np.int32)
    qp = qp.astype(np.int32)
    ls = 16 * T.QUANT_V[qp % 6]
    qdiv = (qp // 6)[..., None, None]
    hi = (c * ls) << np.maximum(qdiv - 4, 0)
    lo = (c * ls + (1 << np.maximum(3 - qdiv, 0))) >> np.maximum(4 - qdiv, 0)
    return np.where(qp[..., None, None] >= 24, hi, lo)


def _idct_np(d: np.ndarray) -> np.ndarray:
    """8.5.12.2 inverse core transform; d (...,4,4) int32."""
    d = d.astype(np.int32)
    d0, d1, d2, d3 = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
    e0, e1 = d0 + d2, d0 - d2
    e2, e3 = (d1 >> 1) - d3, d1 + (d3 >> 1)
    f = np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis=-1)
    f0, f1, f2, f3 = f[..., 0, :], f[..., 1, :], f[..., 2, :], f[..., 3, :]
    g0, g1 = f0 + f2, f0 - f2
    g2, g3 = (f1 >> 1) - f3, f1 + (f3 >> 1)
    h = np.stack([g0 + g3, g1 + g2, g1 - g2, g0 - g3], axis=-2)
    return (h + 32) >> 6


def _hadamard4_np(x):
    x0, x1, x2, x3 = x[..., 0, :], x[..., 1, :], x[..., 2, :], x[..., 3, :]
    a0, a1 = x0 + x1, x0 - x1
    b0, b1 = x2 + x3, x2 - x3
    t = np.stack([a0 + b0, a0 - b0, a1 - b1, a1 + b1], axis=-2)
    t0, t1, t2, t3 = t[..., 0], t[..., 1], t[..., 2], t[..., 3]
    c0, c1 = t0 + t1, t0 - t1
    d0, d1 = t2 + t3, t2 - t3
    return np.stack([c0 + d0, c0 - d0, c1 - d1, c1 + d1], axis=-1)


def _luma_dc_descale_np(c: np.ndarray, qp: np.ndarray) -> np.ndarray:
    """8.5.10 (Intra16x16 luma DC); c (...,4,4) int32, qp (...,)."""
    f = _hadamard4_np(c.astype(np.int32))
    qp = qp.astype(np.int32)
    scale = (16 * T.QUANT_V[qp % 6, 0, 0])[..., None, None]
    qdiv = (qp // 6)[..., None, None]
    hi = (f * scale) << np.maximum(qdiv - 6, 0)
    lo = (f * scale + (1 << np.maximum(5 - qdiv, 0))) >> \
        np.maximum(6 - qdiv, 0)
    return np.where(qp[..., None, None] >= 36, hi, lo)


def _chroma_dc_descale_np(c: np.ndarray, qp: np.ndarray) -> np.ndarray:
    """8.5.11 (4:2:0); c (...,2,2) int32, qp (...,)."""
    c = c.astype(np.int32)
    qp = qp.astype(np.int32)
    t00 = c[..., 0, 0] + c[..., 1, 0]
    t01 = c[..., 0, 1] + c[..., 1, 1]
    t10 = c[..., 0, 0] - c[..., 1, 0]
    t11 = c[..., 0, 1] - c[..., 1, 1]
    f = np.stack([np.stack([t00 + t01, t00 - t01], axis=-1),
                  np.stack([t10 + t11, t10 - t11], axis=-1)], axis=-2)
    scale = (16 * T.QUANT_V[qp % 6, 0, 0])[..., None, None]
    return ((f * scale) << (qp // 6)[..., None, None]) >> 5


# ---------------------------------------------------------------------------
# Fast-path frame payload
# ---------------------------------------------------------------------------

@dataclass
class FastFrame:
    smb: np.ndarray           # (nMB, 8) int32 MC window words
    aux: np.ndarray           # (D2, KD, NAUX) int16 deblock params
    tags: np.ndarray          # (NR,) int32 packed skewed targets
    vals: np.ndarray          # (NR, 16) int16 transposed residual blocks
    counts: np.ndarray        # (3,) int32 [n_luma, n_u, n_v] prefix counts
    wslot: int
    ref_slot: int
    ilist: np.ndarray = None  # (nI, 4) int32 intra MB list (raster order)
    ivals: np.ndarray = None  # (nI, 24, 16) int16 dense intra residual


# quarter-pel case table: case = 4*fy + fx -> (p0,dx0,dy0,p1,dx1,dy1)
from hartallo_tpu_torch.ops.wide import _QPT as _QPT_NP  # noqa: E402

_TC0X = np.concatenate([np.zeros((52, 1), np.int64), DEBLOCK_TC0], axis=1)
NAUX = 62


def _mc_words_np(sd):
    """Per-quadrant MC window words (two per quadrant: luma, chroma).

    Mirrors ops/wide.mc_luma_plane's per-block clamp semantics (host
    ``eligible`` has verified the quadrant blocks clamp uniformly).
    Reference: clamped index maps, hl_codec_264_interpol.c:74-160."""
    gh, gw = sd.gh, sd.gw
    n = gh * gw
    W, H, Wc, Hc = gw * 16, gh * 16, gw * 8, gh * 8
    mvq = sd.mv[:, :, ::2, ::2, :].reshape(n, 4, 2).astype(np.int64)
    mvx, mvy = mvq[..., 0], mvq[..., 1]
    mb = np.arange(n)
    mx = (mb % gw)[:, None]
    my = (mb // gw)[:, None]
    qx = np.array([0, 1, 0, 1])[None, :]
    qy = np.array([0, 0, 1, 1])[None, :]
    xi = np.clip(mx * 16 + qx * 8 + (mvx >> 2), -(PAD - 2), W + PAD - 7)
    yi = np.clip(my * 16 + qy * 8 + (mvy >> 2), -(PAD - 2), H + PAD - 7)
    q = _QPT_NP[(mvy & 3) * 4 + (mvx & 3)]         # (n, 4, 6)
    wl = ((yi + PAD) << 20) | ((xi + PAD) << 8) |         (q[..., 0] << 6) | (q[..., 3] << 4) | (q[..., 2] << 3) |         (q[..., 1] << 2) | (q[..., 5] << 1) | q[..., 4]
    cxi = np.clip(mx * 8 + qx * 4 + (mvx >> 3), -(PAD - 1), Wc + PAD - 4)
    cyi = np.clip(my * 8 + qy * 4 + (mvy >> 3), -(PAD - 1), Hc + PAD - 4)
    wc = ((cyi + PAD) << 17) | ((cxi + PAD) << 6) |         ((mvy & 7) << 3) | (mvx & 7)
    return np.concatenate([wl, wc], axis=-1).astype(np.int32)


def _bs_grids_np(sd, fmb_v, fmb_h, fint):
    """8.7.2.1 boundary strengths on the 4x4 grid (numpy port of
    ops/wide.compute_bs_grids; single reference slot per frame, so the
    ref-difference term never fires)."""
    gh, gw = sd.gh, sd.gw
    nnz = sd.nnz_luma > 0                            # (4gh, 4gw)
    mvg = sd.mv.transpose(0, 2, 1, 3, 4).reshape(4 * gh, 4 * gw, 2)
    rep = lambda a: np.repeat(np.repeat(a, 4, 0), 4, 1)   # noqa: E731
    bi = rep(sd.mb_kind <= 2)                        # intra (incl. PCM)

    def shift1(a, axis):
        out = np.empty_like(a)
        if axis == 0:
            out[0] = a[0]
            out[1:] = a[:-1]
        else:
            out[:, 0] = a[:, 0]
            out[:, 1:] = a[:, :-1]
        return out

    def edge_bs(axis):
        intra_pq = bi | shift1(bi, axis)
        nz_pq = nnz | shift1(nnz, axis)
        dmv = np.abs(mvg - shift1(mvg, axis))
        mv_far = (dmv >= 4).any(axis=-1)
        return np.where(intra_pq, 4,
                        np.where(nz_pq, 2, np.where(mv_far, 1, 0)))

    bs_vg = edge_bs(1)
    bs_hg = edge_bs(0)
    internal_v = (np.arange(4 * gw) % 4 != 0)[None, :]
    internal_h = (np.arange(4 * gh) % 4 != 0)[:, None]
    bs_vg = np.where(internal_v & (bs_vg == 4), 3, bs_vg)
    bs_hg = np.where(internal_h & (bs_hg == 4), 3, bs_hg)
    fv, fh, fi = rep(fmb_v), rep(fmb_h), rep(fint)
    bs_vg = np.where(np.where(internal_v, fi, fv), bs_vg, 0)
    bs_hg = np.where(np.where(internal_h, fi, fh), bs_hg, 0)
    return bs_vg, bs_hg


def _aux_np(sd, fmb_v, fmb_h, fint, chroma_qp_off: int):
    """(gh, gw, NAUX) int16 deblock params (sheared to diagonals on
    device).  Layout documented in d_gop_pallas.py; thresholds per
    8.7.2.2."""
    gh, gw = sd.gh, sd.gw
    qp = sd.qp.astype(np.int64)
    offa = sd.alpha_off.astype(np.int64)
    offb = sd.beta_off.astype(np.int64)
    bs_vg, bs_hg = _bs_grids_np(sd, fmb_v, fmb_h, fint)
    bs_v = bs_vg.reshape(gh, 4, gw, 4).transpose(0, 2, 3, 1)
    bs_h = bs_hg.reshape(gh, 4, gw, 4).transpose(0, 2, 1, 3)

    qp_l = np.concatenate([qp[:, :1], qp[:, :-1]], axis=1)
    qp_t = np.concatenate([qp[:1, :], qp[:-1, :]], axis=0)
    qpc = QP_SCALE_CHROMA[np.clip(qp + chroma_qp_off, 0, 51)].astype(
        np.int64)
    qpc_l = np.concatenate([qpc[:, :1], qpc[:, :-1]], axis=1)
    qpc_t = np.concatenate([qpc[:1, :], qpc[:-1, :]], axis=0)

    def ab_t(qe):
        ia = np.clip(qe + offa, 0, 51)
        ib = np.clip(qe + offb, 0, 51)
        return (DEBLOCK_ALPHA[ia], DEBLOCK_BETA[ib], _TC0X[ia][..., 1:4])

    a_ev, b_ev, t_ev = ab_t((qp_l + qp + 1) >> 1)
    a_eh, b_eh, t_eh = ab_t((qp_t + qp + 1) >> 1)
    a_i, b_i, t_i = ab_t(qp)
    ca_ev, cb_ev, ct_ev = ab_t((qpc_l + qpc + 1) >> 1)
    ca_eh, cb_eh, ct_eh = ab_t((qpc_t + qpc + 1) >> 1)
    ca_i, cb_i, ct_i = ab_t(qpc)
    ab = np.stack([a_ev, b_ev, a_eh, b_eh, a_i, b_i,
                   ca_ev, cb_ev, ca_eh, cb_eh, ca_i, cb_i], axis=-1)
    ts = np.concatenate([t_ev, t_eh, t_i, ct_ev, ct_eh, ct_i], axis=-1)
    bs = np.concatenate([bs_v.reshape(gh, gw, 16),
                         bs_h.reshape(gh, gw, 16)], axis=-1)
    return np.concatenate([ab, ts, bs], axis=-1).astype(np.int16)


def eligible(sd, wp_l) -> Optional[str]:
    """Why this picture can NOT take the fast path (None = it can).

    Fast path scope: I and P pictures with any number of intra MBs (no
    PCM or I_BL), per-8x8-quadrant-uniform MVs
    (including after the MC window edge clamp), one reference slot for
    the whole frame, no weighted prediction, residual magnitudes within
    the int16 work-plane budget.
    """
    kind = sd.mb_kind
    if ((kind < 0) | (kind == 2) | (kind == 8)).any():
        return "PCM/IBL macroblocks"
    if wp_l is not None:
        return "weighted prediction"
    if sd.gw * 16 > 1920 or sd.gh * 16 > 1088:
        return "frame too large for VMEM-resident fast path"
    v = sd.mv.reshape(sd.gh, sd.gw, 2, 2, 2, 2, 2)
    if not (v == v[:, :, :, :1, :, :1, :]).all():
        return "sub-8x8 motion partitions"
    slots = np.unique(sd.ref_idx)
    if slots.size != 1:
        return "multiple reference slots in one frame"
    # window clamp must hit all four 4x4 blocks of a quadrant equally
    # (the kernel derives ONE window per quadrant; the XLA/reference
    # semantics clamp per 4x4 block)
    gh, gw = sd.gh, sd.gw
    W, H, Wc, Hc = gw * 16, gh * 16, gw * 8, gh * 8
    mvx = sd.mv[..., 0]
    mvy = sd.mv[..., 1]
    b4 = np.arange(4)
    bx = (np.arange(gw)[None, :, None] * 16 + b4 * 4)[:, :, None, :]
    by = (np.arange(gh)[:, None, None] * 16 + b4 * 4)[:, :, :, None]
    xi = np.clip(bx + (mvx >> 2), -(PAD - 2), W + PAD - 7)
    yi = np.clip(by + (mvy >> 2), -(PAD - 2), H + PAD - 7)
    cxi = np.clip(bx // 2 + (mvx >> 3), -(PAD - 1), Wc + PAD - 4)
    cyi = np.clip(by // 2 + (mvy >> 3), -(PAD - 1), Hc + PAD - 4)
    off = np.array([0, 4])
    # xi axes are (gh, gw, by4, bx4) -> (gh, gw, qy, iy, qx, ix)
    ok = True
    ok &= bool((xi.reshape(gh, gw, 2, 2, 2, 2) ==
                xi.reshape(gh, gw, 2, 2, 2, 2)[:, :, :, :1, :, :1] +
                off[None, None, None, None, None, :]).all())
    ok &= bool((yi.reshape(gh, gw, 2, 2, 2, 2) ==
                yi.reshape(gh, gw, 2, 2, 2, 2)[:, :, :, :1, :, :1] +
                off[None, None, None, :, None, None]).all())
    co = np.array([0, 2])
    ok &= bool((cxi.reshape(gh, gw, 2, 2, 2, 2) ==
                cxi.reshape(gh, gw, 2, 2, 2, 2)[:, :, :, :1, :, :1] +
                co[None, None, None, None, None, :]).all())
    ok &= bool((cyi.reshape(gh, gw, 2, 2, 2, 2) ==
                cyi.reshape(gh, gw, 2, 2, 2, 2)[:, :, :, :1, :, :1] +
                co[None, None, None, :, None, None]).all())
    if not ok:
        return "edge-clamped quadrant windows diverge"
    return None


def pack_fast(sd, fmb_v, fmb_h, fint, wslot: int, chroma_qp_off: int,
              al=None, at=None, atr=None) -> FastFrame:
    """Build the compact fast-path payload for one picture.

    Precondition: ``eligible`` returned None (sd.ref_idx is slot-mapped,
    derive_mvs has run).  al/at/atr: intra neighbour availability masks
    (gh, gw) bool; may be None for all-inter pictures.

    One native pass over the MBs (``native/packc.c``) when its library
    loads, counted in ``decode.pack_native``; ``pack_fast_py`` otherwise.
    Both give the same bytes and raise OverflowError on the same pictures.
    """
    if not native_pack.available():
        return pack_fast_py(sd, fmb_v, fmb_h, fint, wslot, chroma_qp_off,
                            al=al, at=at, atr=atr)
    smb, aux, tags, vals, counts, ilist, ivals = native_pack.pack_frame(
        sd, fmb_v, fmb_h, fint, chroma_qp_off, al, at, atr)
    tracing.add("decode.pack_native")
    return FastFrame(smb=smb, aux=aux, tags=tags, vals=vals, counts=counts,
                     wslot=int(wslot), ref_slot=int(sd.ref_idx.flat[0]),
                     ilist=ilist, ivals=ivals)


def pack_fast_py(sd, fmb_v, fmb_h, fint, wslot: int, chroma_qp_off: int,
                 al=None, at=None, atr=None) -> FastFrame:
    """``pack_fast`` in numpy over whole arrays: the oracle of the native
    pass, and the path where its library does not load."""
    gh, gw = sd.gh, sd.gw
    n = gh * gw

    # ---- device control payloads --------------------------------------
    smb = _mc_words_np(sd)
    aux = _aux_np(sd, fmb_v, fmb_h, fint, chroma_qp_off)

    # ---- residual pool (inter MBs; natural padded-plane coords) -------
    qp = sd.qp.reshape(n).astype(np.int32)
    qpc = QP_SCALE_CHROMA[np.clip(qp + chroma_qp_off, 0, 51)]
    kind = sd.mb_kind.reshape(n)
    is_intra = kind <= 2

    lac = sd.luma_ac.reshape(n, 16, 4, 4)
    # nnz_luma is the parsed per-4x4 TotalCoeff — nonzero iff the block
    # has coded (nonzero) levels, so no coefficient scan is needed
    nnzb = (sd.nnz_luma.reshape(gh, 4, gw, 4).transpose(0, 2, 1, 3)
            .reshape(n, 16) > 0)
    lnz = nnzb[:, _BLK_RASTER_OF] & ~is_intra[:, None]   # blkIdx order
    lm, lb = np.nonzero(lnz)
    r_l = _idct_np(_dequant_np(lac[lm, lb], qp[lm])) if lm.size else \
        np.zeros((0, 4, 4), np.int32)

    cac = sd.chroma_ac.reshape(n, 2, 4, 4, 4)
    dcc = _chroma_dc_descale_np(
        sd.chroma_dc.reshape(n, 2, 2, 2),
        np.broadcast_to(qpc[:, None], (n, 2)))       # (n,2,2,2)
    dcc_blk = dcc.reshape(n, 2, 4)                   # raster == blk order
    cnnz = (sd.nnz_chroma.reshape(gh, 2, gw, 2, 2)
            .transpose(0, 2, 4, 1, 3).reshape(n, 2, 4) > 0)
    cnz = (cnnz | (dcc_blk != 0)) & ~is_intra[:, None, None]
    cm, cp, cb = np.nonzero(cnz)
    if cm.size:
        d_c = _dequant_np(cac[cm, cp, cb], qpc[cm])
        d_c[:, 0, 0] = dcc_blk[cm, cp, cb]
        r_c = _idct_np(d_c)
    else:
        r_c = np.zeros((0, 4, 4), np.int32)

    # ---- intra pools ---------------------------------------------------
    im = np.nonzero(is_intra)[0]                     # raster order
    n_i = im.size
    ilist = np.zeros((n_i, 4), np.int32)
    ivals = np.zeros((n_i, 24, 16), np.int16)
    if n_i:
        if al is None:
            al = np.zeros((gh, gw), bool)
        if at is None:
            at = np.zeros((gh, gw), bool)
        if atr is None:
            atr = np.zeros((gh, gw), bool)
        i16 = (kind[im] == 1).astype(np.int64)
        w = i16 | \
            (np.clip(sd.i16_mode.reshape(n)[im], 0, 3).astype(np.int64)
             << 1) | \
            (np.clip(sd.chroma_mode.reshape(n)[im], 0, 3).astype(np.int64)
             << 3) | \
            (al.reshape(n)[im].astype(np.int64) << 5) | \
            (at.reshape(n)[im].astype(np.int64) << 6) | \
            (atr.reshape(n)[im].astype(np.int64) << 7)
        m4 = np.clip(sd.i4_modes.reshape(n, 16)[im].astype(np.int64),
                     0, 8)                            # (n_i, 16)
        sh = np.arange(8) * 4
        ilist[:, 0] = im
        ilist[:, 1] = w
        ilist[:, 2] = (m4[:, :8] << sh).sum(1)
        ilist[:, 3] = (m4[:, 8:] << sh).sum(1)
        # dense residual per intra MB: 16 luma blkIdx + 4 U + 4 V blocks
        d_li = _dequant_np(lac[im], qp[im, None])     # (n_i,16,4,4)
        dcd = _luma_dc_descale_np(
            sd.luma_dc.reshape(n, 4, 4)[im], qp[im])  # (n_i,4,4) raster
        dc_blk = dcd.reshape(n_i, 16)[:, _BLK_RASTER_OF]
        use16 = (kind[im] == 1)[:, None]
        d_li[..., 0, 0] = np.where(use16, dc_blk, d_li[..., 0, 0])
        r_li = _idct_np(d_li)                          # (n_i,16,4,4)
        d_ci = _dequant_np(cac[im].reshape(n_i, 8, 4, 4),
                           qpc[im, None])
        d_ci[..., 0, 0] = dcc_blk[im].reshape(n_i, 8)
        r_ci = _idct_np(d_ci)                          # (n_i,8,4,4)
        ivals[:, :16] = r_li.reshape(n_i, 16, 16)
        ivals[:, 16:] = r_ci.reshape(n_i, 8, 16)

    # magnitude guard for the clip(pred + res) int32 windows (int16 pool)
    mx = 0
    for arr in (r_l, r_c, ivals):
        if arr.size:
            mx = max(mx, int(np.abs(arr).max()))
    if mx > MAX_RES:
        raise OverflowError("residual exceeds fast-path int16 budget")

    # natural padded-plane targets: tag = (y << 12) | x, 4-aligned
    def l_tags(ms, bs):
        y = PAD + (ms // gw) * 16 + _BLK_Y[bs]
        x = PAD + (ms % gw) * 16 + _BLK_X[bs]
        return ((y << 12) | x).astype(np.int32)

    def c_tags(ms, bs):
        y = PAD + (ms // gw) * 8 + (bs // 2) * 4
        x = PAD + (ms % gw) * 8 + (bs % 2) * 4
        return ((y << 12) | x).astype(np.int32)

    u_sel = cp == 0
    if lm.size + cm.size:
        tags = np.concatenate([
            l_tags(lm, lb),
            c_tags(cm[u_sel], cb[u_sel]),
            c_tags(cm[~u_sel], cb[~u_sel])])
        vals = np.concatenate([
            r_l.reshape(-1, 16),
            r_c[u_sel].reshape(-1, 16),
            r_c[~u_sel].reshape(-1, 16)]).astype(np.int16)
    else:
        tags = np.zeros((0,), np.int32)
        vals = np.zeros((0, 16), np.int16)
    counts = np.array([lm.size, lm.size + int(u_sel.sum()),
                       lm.size + cm.size], np.int32)
    return FastFrame(smb=smb, aux=aux, tags=tags, vals=vals,
                     counts=counts, wslot=int(wslot),
                     ref_slot=int(sd.ref_idx.flat[0]),
                     ilist=ilist, ivals=ivals)


def accumulated_residual_planes_np(coeffs0, coeffs1, chroma_qp_off: int):
    """SVC quality refinement (G.8.5.1 family, tcoeff_level_prediction_
    flag = 0): the scaled transform coefficients of the quality-base
    picture and the refinement picture ACCUMULATE before one inverse
    transform — sTCoeff = deq(L0, qp0) + deq(L1, qp1), residual =
    IDCT(sTCoeff) (G-127..G-130; reference
    _hl_codec_264_decode_svc_refinement_process_transform_coeff_residual_4x4,
    hl_codec_264_decode_svc.c:92-146 family).  Differs from summing the
    two layers' pixel residuals by the single final IDCT rounding.

    coeffs0/coeffs1: (luma_ac (gh,gw,16,4,4), chroma_ac (gh,gw,2,4,4,4),
    chroma_dc (gh,gw,2,2,2), qp (gh,gw)) quantized levels per layer.
    Returns (res_y, res_cb, res_cr) int32 planes."""
    lac0, cac0, cdc0, qp0 = coeffs0
    lac1, cac1, cdc1, qp1 = coeffs1
    gh, gw = qp0.shape
    n = gh * gw
    q0 = np.asarray(qp0, np.int32).reshape(n)
    q1 = np.asarray(qp1, np.int32).reshape(n)
    qc0 = QP_SCALE_CHROMA[np.clip(q0 + chroma_qp_off, 0, 51)]
    qc1 = QP_SCALE_CHROMA[np.clip(q1 + chroma_qp_off, 0, 51)]

    d_l = _dequant_np(np.asarray(lac0, np.int32).reshape(n, 16, 4, 4),
                      q0[:, None]) + \
        _dequant_np(np.asarray(lac1, np.int32).reshape(n, 16, 4, 4),
                    q1[:, None])
    r_l = _idct_np(d_l)
    res_y = np.zeros((gh, gw, 16, 16), np.int32)
    for b in range(16):
        res_y[:, :, _BLK_Y[b]:_BLK_Y[b] + 4, _BLK_X[b]:_BLK_X[b] + 4] = \
            r_l[:, b].reshape(gh, gw, 4, 4)
    res_y = res_y.transpose(0, 2, 1, 3).reshape(gh * 16, gw * 16)

    d_c = _dequant_np(np.asarray(cac0, np.int32).reshape(n, 2, 4, 4, 4),
                      qc0[:, None, None]) + \
        _dequant_np(np.asarray(cac1, np.int32).reshape(n, 2, 4, 4, 4),
                    qc1[:, None, None])
    dcc = _chroma_dc_descale_np(
        np.asarray(cdc0, np.int32).reshape(n, 2, 2, 2),
        np.broadcast_to(qc0[:, None], (n, 2))) + \
        _chroma_dc_descale_np(
            np.asarray(cdc1, np.int32).reshape(n, 2, 2, 2),
            np.broadcast_to(qc1[:, None], (n, 2)))
    d_c[..., 0, 0] = dcc.reshape(n, 2, 4)
    r_c = _idct_np(d_c)
    res_c = np.zeros((gh, gw, 2, 8, 8), np.int32)
    for b in range(4):
        r0, c0 = (b // 2) * 4, (b % 2) * 4
        res_c[:, :, :, r0:r0 + 4, c0:c0 + 4] = \
            r_c[:, :, b].reshape(gh, gw, 2, 4, 4)
    res_c = res_c.transpose(2, 0, 3, 1, 4).reshape(2, gh * 8, gw * 8)
    return res_y, res_c[0], res_c[1]


def residual_planes_np(sd, chroma_qp_off: int):
    """Dense inter-MB residual planes (res_y (H,W), res_cb, res_cr int32)
    for SVC inter-layer residual prediction: the rS sample arrays of
    G.8.5.3/G.8.5.5 — inter macroblocks carry their decoded residual,
    intra/I_BL macroblocks are re-initialised to zero (reference:
    _hl_codec_264_decode_svc_sample_array_reinit call sites,
    hl_codec_264_decode_svc.c:700-830)."""
    gh, gw = sd.gh, sd.gw
    n = gh * gw
    qp = sd.qp.reshape(n).astype(np.int32)
    qpc = QP_SCALE_CHROMA[np.clip(qp + chroma_qp_off, 0, 51)]
    kind = sd.mb_kind.reshape(n)
    inter = (kind >= 3) & (kind != 8)

    lac = sd.luma_ac.reshape(n, 16, 4, 4)
    r_l = _idct_np(_dequant_np(lac, qp[:, None]))       # (n,16,4,4)
    r_l[~inter] = 0
    res_y = np.zeros((gh, gw, 16, 16), np.int32)
    for b in range(16):
        res_y[:, :, _BLK_Y[b]:_BLK_Y[b] + 4, _BLK_X[b]:_BLK_X[b] + 4] = \
            r_l[:, b].reshape(gh, gw, 4, 4)
    res_y = res_y.transpose(0, 2, 1, 3).reshape(gh * 16, gw * 16)

    cac = sd.chroma_ac.reshape(n, 2, 4, 4, 4)
    dcc = _chroma_dc_descale_np(
        sd.chroma_dc.reshape(n, 2, 2, 2),
        np.broadcast_to(qpc[:, None], (n, 2)))
    d_c = _dequant_np(cac, qpc[:, None, None])
    d_c[..., 0, 0] = dcc.reshape(n, 2, 4)
    r_c = _idct_np(d_c)                                  # (n,2,4,4,4)
    r_c[~inter] = 0
    res_c = np.zeros((gh, gw, 2, 8, 8), np.int32)
    for b in range(4):
        r0, c0 = (b // 2) * 4, (b % 2) * 4
        res_c[:, :, :, r0:r0 + 4, c0:c0 + 4] = \
            r_c[:, :, b].reshape(gh, gw, 2, 4, 4)
    res_c = res_c.transpose(2, 0, 3, 1, 4).reshape(2, gh * 8, gw * 8)
    return res_y, res_c[0], res_c[1]
