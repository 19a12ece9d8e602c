"""In-loop deblocking filter (spec 8.7) on torch tensors.

Port of ``hartallo_tpu/ops/deblock.py:deblock_frame_s1`` split in two:

- ``edge_params`` gathers, per MB, the thresholds alpha/beta, the tc0
  triples and the bS of every 4-sample edge segment into one
  (gh, gw, NAUX) tensor laid out as ``d_pool``'s ``aux`` (the layout is
  documented in ``hartallo_tpu/decode/d_gop_pallas.py``);
- ``deblock_filter`` runs the slope-1 wavefront over those parameters:
  for each MB anti-diagonal d = mx + my it filters every vertical edge of
  every MB on d, then every horizontal edge.  Running all V edges of a
  diagonal before all H edges reproduces the spec's per-MB raster order
  (the argument is in ``hartallo_tpu/ops/deblock.py``), and the MBs of a
  diagonal touch disjoint samples within each phase, so a phase is one
  batched gather, filter and scatter per edge.

The GOP kernel's plain twin (``decode/d_gop_fast.py``) runs
``deblock_filter`` on the host-made ``aux``; the CUDA kernel walks the
same schedule.  The slope-2 ``deblock_frame`` is not ported: the JAX
package's tests pin it equal to the slope-1 schedule.
"""
from __future__ import annotations

from functools import lru_cache

import torch

from portbench.reference.h264.core.tables import DEBLOCK_ALPHA, DEBLOCK_BETA, \
    DEBLOCK_TC0
from portbench.reference.h264.ops.wavefront import skew1_geometry
from portbench.reference.h264.ops.wide import compute_bs_grids

PAD = 32
NAUX = 62
AUX_BS = 30          # aux[30:46] = bs_v[e][seg], aux[46:62] = bs_h[e][seg]


# ---------------------------------------------------------------------------
# Edge filters (vectorized over lines)
# ---------------------------------------------------------------------------

def _filter_luma_line(p3, p2, p1, p0, q0, q1, q2, q3, bs, alpha, beta, tc0):
    """One luma edge (8.7.2.3 / 8.7.2.4) over int32 line tensors; returns
    the new p2, p1, p0, q0, q1, q2."""
    fs = (bs > 0) & ((p0 - q0).abs() < alpha) & \
        ((p1 - p0).abs() < beta) & ((q1 - q0).abs() < beta)
    ap = (p2 - p0).abs() < beta
    aq = (q2 - q0).abs() < beta

    tc = tc0 + ap.to(torch.int32) + aq.to(torch.int32)
    delta = torch.clamp((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    p0_w = torch.clamp(p0 + delta, 0, 255)
    q0_w = torch.clamp(q0 - delta, 0, 255)
    p1_w = p1 + torch.clamp((p2 + ((p0 + q0 + 1) >> 1) - (p1 << 1)) >> 1,
                            -tc0, tc0)
    q1_w = q1 + torch.clamp((q2 + ((p0 + q0 + 1) >> 1) - (q1 << 1)) >> 1,
                            -tc0, tc0)
    p1_w = torch.where(ap, p1_w, p1)
    q1_w = torch.where(aq, q1_w, q1)

    gap = (p0 - q0).abs() < ((alpha >> 2) + 2)
    strong_p = ap & gap
    strong_q = aq & gap
    p0_s = torch.where(strong_p,
                       (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                       (2 * p1 + p0 + q1 + 2) >> 2)
    p1_s = torch.where(strong_p, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
    p2_s = torch.where(strong_p,
                       (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    q0_s = torch.where(strong_q,
                       (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                       (2 * q1 + q0 + p1 + 2) >> 2)
    q1_s = torch.where(strong_q, (q2 + q1 + q0 + p0 + 2) >> 2, q1)
    q2_s = torch.where(strong_q,
                       (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)

    is4 = bs == 4
    new = (torch.where(is4, p2_s, p2), torch.where(is4, p1_s, p1_w),
           torch.where(is4, p0_s, p0_w), torch.where(is4, q0_s, q0_w),
           torch.where(is4, q1_s, q1_w), torch.where(is4, q2_s, q2))
    old = (p2, p1, p0, q0, q1, q2)
    return tuple(torch.where(fs, n, o) for n, o in zip(new, old))


def _filter_chroma_line(p1, p0, q0, q1, bs, alpha, beta, tc0):
    """One chroma edge over int32 line tensors; returns the new p0, q0."""
    fs = (bs > 0) & ((p0 - q0).abs() < alpha) & \
        ((p1 - p0).abs() < beta) & ((q1 - q0).abs() < beta)
    tc = tc0 + 1
    delta = torch.clamp((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    p0_w = torch.clamp(p0 + delta, 0, 255)
    q0_w = torch.clamp(q0 - delta, 0, 255)
    p0_s = (2 * p1 + p0 + q1 + 2) >> 2
    q0_s = (2 * q1 + q0 + p1 + 2) >> 2
    is4 = bs == 4
    return (torch.where(fs, torch.where(is4, p0_s, p0_w), p0),
            torch.where(fs, torch.where(is4, q0_s, q0_w), q0))


# ---------------------------------------------------------------------------
# Boundary strengths (per-MB form)
# ---------------------------------------------------------------------------

def compute_bs(mb_is_intra, nnz, mv, ref, filter_mb_edge_v, filter_mb_edge_h,
               filter_internal):
    """bS per 4x4-block edge, the JAX ``compute_bs``: mb_is_intra and the
    filter flags (gh, gw) bool; nnz, ref (4gh, 4gw); mv (4gh, 4gw, 2).
    Returns bs_v, bs_h (gh, gw, 4, 4) [edge][segment].  It is
    ``ops/wide.compute_bs_grids`` with its grids regrouped per MB."""
    gh, gw = mb_is_intra.shape
    bs_vg, bs_hg = compute_bs_grids(mb_is_intra, nnz, mv, ref,
                                    filter_mb_edge_v, filter_mb_edge_h,
                                    filter_internal)
    return (bs_vg.reshape(gh, 4, gw, 4).permute(0, 2, 3, 1),
            bs_hg.reshape(gh, 4, gw, 4).permute(0, 2, 1, 3))


# ---------------------------------------------------------------------------
# Parameter gather
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _threshold_tables(device):
    """(alpha, beta, tc0) tables of 8.7.2.2 as int32 on ``device``, made
    once per device.  Shared: never written."""
    return tuple(torch.as_tensor(t, dtype=torch.int32, device=device)
                 for t in (DEBLOCK_ALPHA, DEBLOCK_BETA, DEBLOCK_TC0))


def edge_params(bs_v, bs_h, qp_y, qp_left, qp_top, qpc_cur, qpc_left,
                qpc_top, alpha_off, beta_off) -> torch.Tensor:
    """Per-MB deblock parameters (gh, gw, NAUX) int32 (8.7.2.2):

    [a_e0v, b_e0v, a_e0h, b_e0h, a_i, b_i,
     ca_e0v, cb_e0v, ca_e0h, cb_e0h, ca_i, cb_i]            (0..11)
    [t_e0v(3), t_e0h(3), t_i(3), ct_e0v(3), ct_e0h(3), ct_i(3)] (12..29)
    [bs_v(4 edges x 4 segments), bs_h(4 x 4)]               (30..61)

    e0v/e0h are the MB's left/top edge (averaged QP), i its internal
    edges; t* are tc0 for bS 1, 2, 3.  bs_v/bs_h (gh, gw, 4, 4)
    [edge][segment]; the QP and offset maps (gh, gw)."""
    alpha_t, beta_t, tc0_t = _threshold_tables(qp_y.device)
    offa = alpha_off.to(torch.int32)
    offb = beta_off.to(torch.int32)

    def ab_t(qe):
        ia = torch.clamp(qe + offa, 0, 51).long()
        ib = torch.clamp(qe + offb, 0, 51).long()
        return alpha_t[ia], beta_t[ib], tc0_t[ia]

    qp, qpc = qp_y.to(torch.int32), qpc_cur.to(torch.int32)
    a_ev, b_ev, t_ev = ab_t((qp_left + qp + 1) >> 1)
    a_eh, b_eh, t_eh = ab_t((qp_top + qp + 1) >> 1)
    a_i, b_i, t_i = ab_t(qp)
    ca_ev, cb_ev, ct_ev = ab_t((qpc_left + qpc + 1) >> 1)
    ca_eh, cb_eh, ct_eh = ab_t((qpc_top + qpc + 1) >> 1)
    ca_i, cb_i, ct_i = ab_t(qpc)
    gh, gw = qp.shape
    ab = torch.stack([a_ev, b_ev, a_eh, b_eh, a_i, b_i,
                      ca_ev, cb_ev, ca_eh, cb_eh, ca_i, cb_i], dim=-1)
    ts = torch.cat([t_ev, t_eh, t_i, ct_ev, ct_eh, ct_i], dim=-1)
    bs = torch.cat([bs_v.reshape(gh, gw, 16), bs_h.reshape(gh, gw, 16)],
                   dim=-1).to(torch.int32)
    return torch.cat([ab, ts, bs], dim=-1)


# ---------------------------------------------------------------------------
# Filter pass (slope-1 wavefront over natural padded planes)
# ---------------------------------------------------------------------------

def _tc0_of(bs, t3):
    """Per-line tc0 from the line's bS and the MB's (tc0 for bS 1, 2, 3)."""
    idx = torch.clamp(bs - 1, 0, 2).long()
    return torch.where(bs > 0, torch.gather(t3, -1, idx), 0)


def _edge(plane, a, ys, xs, n, size, vertical, params, luma):
    """Filter edge ``n`` (sample offset 4n, 2n for chroma 8x8 tiles) of
    the MBs whose top-left samples are (ys, xs), on every line of their
    ``size`` lines, in place.  params = (alpha, beta, tc0 triple, bS
    column offset) indices into aux rows ``a`` (m, NAUX)."""
    ia, ib, it, ibs = params
    dev = plane.device
    nt = 8 if luma else 4
    off = torch.arange(nt, device=dev) - nt // 2 + 4 * n
    lines = torch.arange(size, device=dev)
    if vertical:
        rows = (ys[:, None] + lines)[:, :, None]           # (m, size, 1)
        cols = (xs[:, None] + off)[:, None, :]             # (m, 1, nt)
    else:
        rows = (ys[:, None] + off)[:, None, :]             # (m, 1, nt)
        cols = (xs[:, None] + lines)[:, :, None]           # (m, size, 1)
    smp = plane[rows, cols]                                # (m, size, nt)
    seg = lines // 4 if luma else lines // 2
    bs = a[:, ibs + seg]                                   # (m, size)
    alpha = a[:, ia:ia + 1]
    beta = a[:, ib:ib + 1]
    t3 = a[:, it:it + 3]
    tc0 = _tc0_of(bs, t3)
    cols_in = [smp[..., i] for i in range(nt)]
    if luma:
        out = _filter_luma_line(*cols_in, bs, alpha, beta, tc0)
        keep = slice(1, 7)
    else:
        out = _filter_chroma_line(*cols_in, bs, alpha, beta, tc0)
        keep = slice(1, 3)
    if vertical:
        plane[rows, cols[..., keep]] = torch.stack(out, dim=-1)
    else:
        plane[rows[..., keep], cols] = torch.stack(out, dim=-1)


# aux indices per (luma?, phase, edge): (alpha, beta, tc0 triple, bs base)
def _luma_params(vertical: bool, e: int):
    bs0 = AUX_BS + (0 if vertical else 16) + 4 * e
    if e == 0:
        return (0, 1, 12, bs0) if vertical else (2, 3, 15, bs0)
    return (4, 5, 18, bs0)


def _chroma_params(vertical: bool, e: int):
    bs0 = AUX_BS + (0 if vertical else 16) + 8 * e    # luma edge 2e
    if e == 0:
        return (6, 7, 21, bs0) if vertical else (8, 9, 24, bs0)
    return (10, 11, 27, bs0)


@lru_cache(maxsize=None)
def _diagonals(gw: int, gh: int, device):
    """The (my, mx) MB coordinates of each anti-diagonal of the slope-1
    wavefront, on ``device``, made once per grid and device.  Shared:
    never written."""
    geo = skew1_geometry(gw, gh)
    return tuple(
        tuple(torch.as_tensor(geo[k][d][geo["valid"][d]], device=device)
              for k in ("my_of", "mx_of"))
        for d in range(geo["D"]))


def deblock_filter(planes, aux: torch.Tensor, *, gw: int, gh: int):
    """Filter the PAD-padded int32 planes (Y, U, V) IN PLACE with the
    per-MB parameters ``aux`` (gh, gw, NAUX) of ``edge_params`` /
    ``d_pool``; returns the same planes."""
    pY, pU, pV = planes
    dev = pY.device
    aux = aux.to(device=dev, dtype=torch.int32)
    for my, mx in _diagonals(gw, gh, dev):
        a = aux[my, mx]                                     # (m, NAUX)
        for vertical in (True, False):
            for e in range(4):
                _edge(pY, a, PAD + 16 * my, PAD + 16 * mx, e, 16, vertical,
                      _luma_params(vertical, e), True)
            for pc in (pU, pV):
                for e in range(2):
                    _edge(pc, a, PAD + 8 * my, PAD + 8 * mx, e, 8, vertical,
                          _chroma_params(vertical, e), False)
    return pY, pU, pV


def deblock_frame_s1(planes, bs_v, bs_h, qp_y, qp_left, qp_top,
                     qpc_cur, qpc_left, qpc_top, alpha_off, beta_off,
                     *, gw: int, gh: int):
    """Same contract as the JAX ``deblock_frame_s1``: planes are
    PAD-padded int32 (Y, U, V); returns new filtered planes."""
    aux = edge_params(bs_v, bs_h, qp_y, qp_left, qp_top, qpc_cur,
                      qpc_left, qpc_top, alpha_off, beta_off)
    return deblock_filter(tuple(p.to(torch.int32).clone() for p in planes),
                          aux, gw=gw, gh=gh)
