"""G.8.6.1 inter-layer motion inference (decode + encode shared).

Two paths, selected by :func:`infer_motion`:

- **RSRC** (RestrictedSpatialResolutionChange — progressive, zero
  scaled-ref-layer offsets, dyadic (2x) or same-resolution layers):
  the spec's mixed-partition cleanup steps (G-210..G-215) and the 8x8
  merge steps (G-244..G-261) are skipped and the derivation collapses
  to an index mapping (``infer_inter_layer_motion``).
- **ESS** (extended spatial scalability — arbitrary resolution ratio,
  progressive, zero offsets): the full G.8.6.1.1/.2 derivation
  (``infer_inter_layer_motion_ess``): per-4x4 reference-layer position
  mapping through the G-9..G-14 scale factors, intra-hole cleanup
  (G-210..G-215), refIdx minPositive merging (G-244..G-248) and the
  mvDiff-classified sub-partition averaging (G-251..G-261).
  Reference parity: ``hl_codec_264_utils.c:965-1029`` (G.6.1) and
  ``:1674-2006`` (G.8.6.1.1/.2); its RestrictedSpatialResolutionChangeFlag
  derivation is ``hl_codec_264_layer.c:143-156``.  One deliberate
  divergence: the reference's G-210 condition tests
  ``refLayerPartIdc[xO+1] == -1`` where the spec (and JSVM
  xSetPartIdcArray) require the *neighbour* to be valid (!= -1); we
  implement the spec reading (the branch is unreachable in streams our
  encoder emits — base pictures are uniformly inter or intra).

The RSRC mapping:

- EL 4x4 block (BX, BY) -> base 4x4 block (BX >> s, BY >> s), s = ratio
  log2 (0 or 1);
- mv scale (G-232..G-235) is exactly ``mv << s`` for dyadic with zero
  offsets; refIdx copies unchanged (G-222, progressive);
- an EL MB whose reference-layer blocks are intra becomes I_BL (the
  intraILPredFlag branch of G.8.6.1.1) — uniform per MB under RSRC.

Reference parity: ``hl_codec_264_utils.c:1674-2006`` (G.8.6.1.1/.2) and
``:1498-1671`` (G.8.4.1 SVC — base_mode MBs take mvILPred/refIdxILPred
verbatim, no mvd).
"""
from __future__ import annotations

import numpy as np


def infer_inter_layer_motion(base_mv: np.ndarray, base_ref: np.ndarray,
                             base_intra: np.ndarray,
                             gw: int, gh: int, ratio: int):
    """Derive EL motion for base_mode_flag=1 macroblocks.

    base_mv (bgh, bgw, 4, 4, 2) int32 quarter-pel; base_ref
    (bgh, bgw, 4) per-8x8 refIdx; base_intra (bgh, bgw) bool;
    ratio in (1, 2): EL/base luma size ratio.

    Returns (mv (gh, gw, 4, 4, 2), ref (gh, gw, 4), ibl (gh, gw) bool).
    """
    assert ratio in (1, 2)
    bgh, bgw = base_intra.shape
    s = ratio - 1                      # log2 for ratio 2; 0 for same-res

    # EL 4x4 block global coords -> base block coords
    BY = (np.arange(gh * 4)[:, None] >> s)        # (4gh, 1)
    BX = (np.arange(gw * 4)[None, :] >> s)        # (1, 4gw)
    BY = np.broadcast_to(BY, (gh * 4, gw * 4))
    BX = np.broadcast_to(BX, (gh * 4, gw * 4))
    bmy, by_in = BY >> 2, BY & 3
    bmx, bx_in = BX >> 2, BX & 3
    bmy = np.clip(bmy, 0, bgh - 1)
    bmx = np.clip(bmx, 0, bgw - 1)

    mv_g = base_mv[bmy, bmx, by_in, bx_in] << s   # (4gh, 4gw, 2), G-234/5
    mv = mv_g.reshape(gh, 4, gw, 4, 2).transpose(0, 2, 1, 3, 4).copy()

    part = (by_in >> 1) * 2 + (bx_in >> 1)        # base 8x8 partition
    ref_g = base_ref[bmy, bmx, part]              # (4gh, 4gw), G-222
    # per EL 8x8: the top-left block's value (G.8.6.1.2 under RSRC)
    ref = ref_g.reshape(gh, 4, gw, 4)[:, ::2, :, ::2] \
        .reshape(gh, 2, gw, 2).transpose(0, 2, 1, 3).reshape(gh, gw, 4)
    ref = ref.astype(base_ref.dtype).copy()

    # intraILPredFlag: uniform per EL MB under RSRC (one base MB covers
    # the whole EL MB for both ratios)
    my = np.clip(np.arange(gh) >> s, 0, bgh - 1)
    mx = np.clip(np.arange(gw) >> s, 0, bgw - 1)
    ibl = base_intra[my[:, None], mx[None, :]]
    return mv, ref, ibl


def _min_positive(a, b):
    """HL_MATH_MIN_POSITIVE (G-245): min when both >= 0, else max."""
    both = (a >= 0) & (b >= 0)
    return np.where(both, np.minimum(a, b), np.maximum(a, b))


def infer_inter_layer_motion_ess(base_mv: np.ndarray,
                                 base_ref: np.ndarray,
                                 base_intra: np.ndarray,
                                 gw: int, gh: int):
    """Full G.8.6.1 derivation for arbitrary (non-dyadic) resolution
    ratios — progressive frames, zero scaled-ref-layer offsets.

    Same array contract as :func:`infer_inter_layer_motion`.
    """
    bgh, bgw = base_intra.shape
    ref_w, ref_h = bgw * 16, bgh * 16          # RefLayerPicSizeInSamplesL
    scaled_w, scaled_h = gw * 16, gh * 16      # ScaledRefLayerPic* (G-3/4)

    # ---- G.6.1: reference-layer position per EL 4x4 block centre -----
    # (xP, yP) = (4x+1, 4y+1) within the MB (G.8.6.1.1); scale G-9/G-10,
    # map G-13/G-14, clamp G-13bis/G-14ter.  shift = 16 (level <= 3.0).
    scale_x = ((ref_w << 16) + (scaled_w >> 1)) // scaled_w
    scale_y = ((ref_h << 16) + (scaled_h >> 1)) // scaled_h
    xc = np.arange(gw * 4, dtype=np.int64) * 4 + 1     # EL sample coords
    yc = np.arange(gh * 4, dtype=np.int64) * 4 + 1
    x_ref = np.minimum((xc * scale_x + (1 << 15)) >> 16, ref_w - 1)
    y_ref = np.minimum((yc * scale_y + (1 << 15)) >> 16, ref_h - 1)
    bmx = (x_ref >> 4)[None, :]                        # base MB coords
    bmy = (y_ref >> 4)[:, None]
    bbx = ((x_ref & 15) >> 2)[None, :]                 # base 4x4-in-MB
    bby = ((y_ref & 15) >> 2)[:, None]
    bmx, bmy = np.broadcast_arrays(bmx, bmy)
    bbx, bby = np.broadcast_arrays(bbx, bby)

    # refLayerPartIdc == -1 marks intra reference blocks (G-209); we
    # carry the block identity as (bmy, bmx, bby, bbx) plus a validity
    # mask instead of the packed integer.
    valid = ~base_intra[bmy, bmx]                      # (4gh, 4gw)

    # per-MB view helpers: (gh, gw, 4, 4[, ...])
    def mbv(a):
        s = a.shape[2:]
        return a.reshape(gh, 4, gw, 4, *s).transpose(
            0, 2, 1, 3, *range(4, 4 + len(s)))

    def flat(a):
        s = a.shape[4:]
        return a.transpose(0, 2, 1, 3, *range(4, 4 + len(s))) \
            .reshape(gh * 4, gw * 4, *s)

    idx = np.stack([bmy, bmx, bby, bbx], axis=-1)      # block identity
    v = mbv(valid).copy()                              # (gh, gw, 4, 4)
    ix = mbv(idx).copy()                               # (gh, gw, 4, 4, 4)
    ibl = ~v.any(axis=(2, 3))                          # intraILPredFlag

    # ---- G-210..G-215: intra-hole cleanup inside mixed MBs -----------
    mixed = ~ibl & ~v.all(axis=(2, 3))
    if mixed.any():
        # 4x4 level inside each 8x8 (sequential (yS, xS) order with
        # processed-flags, vectorised over MBs)
        for yp in range(2):
            for xp in range(2):
                yo, xo = yp * 2, xp * 2
                proc = np.zeros((gh, gw, 2, 2), bool)
                for ys in range(2):
                    for xs in range(2):
                        hole = mixed & ~v[:, :, yo + ys, xo + xs]
                        proc[:, :, ys, xs] |= hole
                        cands = [(ys, 1 - xs), (1 - ys, xs),
                                 (1 - ys, 1 - xs)]        # G-210/211/212
                        filled = np.zeros_like(hole)
                        for cy, cx in cands:
                            ok = hole & ~filled & \
                                ~proc[:, :, cy, cx] & \
                                v[:, :, yo + cy, xo + cx]
                            if ok.any():
                                ix[ok, yo + ys, xo + xs] = \
                                    ix[ok, yo + cy, xo + cx]
                                v[ok, yo + ys, xo + xs] = True
                                filled |= ok
        # 8x8 level (G-213..G-215): fill fully-intra 8x8s from a
        # neighbouring 8x8's adjacent column/row
        proc8 = np.zeros((gh, gw, 2, 2), bool)
        for yp in range(2):
            for xp in range(2):
                hole = mixed & ~v[:, :, yp * 2, xp * 2]
                proc8[:, :, yp, xp] |= hole
                # G-213: horizontal neighbour's column 2-xp
                ok = hole & ~proc8[:, :, yp, 1 - xp] & \
                    v[:, :, yp * 2, 2 - xp]
                done = ok.copy()
                for ys in range(2):
                    for xs in range(2):
                        ix[ok, yp * 2 + ys, xp * 2 + xs] = \
                            ix[ok, yp * 2 + ys, 2 - xp]
                        v[ok, yp * 2 + ys, xp * 2 + xs] = True
                # G-214: vertical neighbour's row 2-yp
                ok = hole & ~done & ~proc8[:, :, 1 - yp, xp] & \
                    v[:, :, 2 - yp, xp * 2]
                done |= ok
                for ys in range(2):
                    for xs in range(2):
                        ix[ok, yp * 2 + ys, xp * 2 + xs] = \
                            ix[ok, 2 - yp, xp * 2 + xs]
                        v[ok, yp * 2 + ys, xp * 2 + xs] = True
                # G-215: diagonal neighbour's corner
                ok = hole & ~done & ~proc8[:, :, 1 - yp, 1 - xp] & \
                    v[:, :, 2 - yp, 2 - xp]
                for ys in range(2):
                    for xs in range(2):
                        ix[ok, yp * 2 + ys, xp * 2 + xs] = \
                            ix[ok, 2 - yp, 2 - xp]
                        v[ok, yp * 2 + ys, xp * 2 + xs] = True

    # ---- G.8.6.1.2: refIdx + mv fetch and scaling --------------------
    fy, fx = flat(ix)[..., 0], flat(ix)[..., 1]
    fby, fbx = flat(ix)[..., 2], flat(ix)[..., 3]
    fv = flat(v)
    part = (fby >> 1) * 2 + (fbx >> 1)
    t_ref = np.where(fv, base_ref[fy, fx, part], -1)   # G-216/G-222
    mvx = np.where(fv, base_mv[fy, fx, fby, fbx, 0], 0).astype(np.int64)
    mvy = np.where(fv, base_mv[fy, fx, fby, fbx, 1], 0).astype(np.int64)
    # G-232..G-235 (zero offsets: dOX=dOY=dSW=dSH=0)
    mscale_x = ((scaled_w << 16) + (ref_w >> 1)) // ref_w
    mscale_y = ((scaled_h << 16) + (ref_h >> 1)) // ref_h
    mvx = (mvx * mscale_x + 32768) >> 16
    mvy = (mvy * mscale_y + 32768) >> 16
    mv = np.stack([mvx, mvy], axis=-1).astype(np.int64)  # (4gh, 4gw, 2)

    mv8 = mbv(mv).copy()                # (gh, gw, 4, 4, 2)
    tr8 = mbv(t_ref).copy()             # (gh, gw, 4, 4)

    # ---- G-244..G-248: per-8x8 refIdx merge + mv replacement ---------
    ref = np.zeros((gh, gw, 4), dtype=base_ref.dtype)
    for yp in range(2):
        for xp in range(2):
            r = tr8[:, :, yp * 2, xp * 2]
            for ys in range(2):
                for xs in range(2):
                    r = _min_positive(r, tr8[:, :, yp * 2 + ys,
                                             xp * 2 + xs])       # G-244
            for ys in range(2):
                for xs in range(2):
                    y4, x4 = yp * 2 + ys, xp * 2 + xs
                    bad = tr8[:, :, y4, x4] != r
                    if not bad.any():
                        continue
                    for cy, cx in ((y4, xp * 2 + 1 - xs),
                                   (yp * 2 + 1 - ys, x4),
                                   (yp * 2 + 1 - ys, xp * 2 + 1 - xs)):
                        ok = bad & (tr8[:, :, cy, cx] == r)
                        mv8[ok, y4, x4] = mv8[ok, cy, cx]  # G-246/7/8
                        bad &= ~ok
                    # G-248 fallback: diagonal unconditionally
                    mv8[bad, y4, x4] = mv8[bad, yp * 2 + 1 - ys,
                                           xp * 2 + 1 - xs]
            ref[:, :, yp * 2 + xp] = np.maximum(r, 0)

    # ---- G-251..G-261: sub-partition classification + averaging ------
    for yp in range(2):
        for xp in range(2):
            yo, xo = yp * 2, xp * 2
            a = mv8[:, :, yo, xo].astype(np.int64)
            b = mv8[:, :, yo, xo + 1].astype(np.int64)
            c = mv8[:, :, yo + 1, xo].astype(np.int64)
            d = mv8[:, :, yo + 1, xo + 1].astype(np.int64)

            def diff(u, w):
                return np.abs(u - w).sum(axis=-1)      # G-251 mvDiff
            is88 = (diff(a, b) <= 1) & (diff(a, c) <= 1) & (diff(a, d) <= 1)
            is84 = ~is88 & (diff(a, b) <= 1) & (diff(c, d) <= 1)
            is48 = ~is88 & ~is84 & (diff(a, c) <= 1) & (diff(b, d) <= 1)
            m88 = (a + b + c + d + 2) >> 2             # G-252
            top, bot = (a + b + 1) >> 1, (c + d + 1) >> 1   # G-253/4
            lef, rig = (a + c + 1) >> 1, (b + d + 1) >> 1   # G-255/6
            for (ys, xs) in ((0, 0), (0, 1), (1, 0), (1, 1)):
                cur = mv8[:, :, yo + ys, xo + xs]
                cur = np.where(is88[..., None], m88, cur)
                cur = np.where(is84[..., None], top if ys == 0 else bot,
                               cur)
                cur = np.where(is48[..., None], lef if xs == 0 else rig,
                               cur)
                mv8[:, :, yo + ys, xo + xs] = cur

    return (mv8.astype(np.int32), ref, ibl)


def infer_motion(base_mv: np.ndarray, base_ref: np.ndarray,
                 base_intra: np.ndarray, gw: int, gh: int):
    """Dispatch: RSRC index-mapping when the per-axis ratio is uniform
    dyadic or same-res (hl_codec_264_layer.c:143-156 flag semantics with
    zero offsets), else the full ESS derivation."""
    bgh, bgw = base_intra.shape
    if (gw, gh) == (bgw, bgh):
        return infer_inter_layer_motion(base_mv, base_ref, base_intra,
                                        gw, gh, 1)
    if (gw, gh) == (bgw * 2, bgh * 2):
        return infer_inter_layer_motion(base_mv, base_ref, base_intra,
                                        gw, gh, 2)
    return infer_inter_layer_motion_ess(base_mv, base_ref, base_intra,
                                        gw, gh)
