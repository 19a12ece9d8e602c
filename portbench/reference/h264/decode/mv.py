"""Motion vector prediction core + derivation passes (spec 8.4.1).

Reference parity: ``hl_codec_264_utils.c:620-965`` (8.4.1 MV + refIdx
derivation incl. median luma MV prediction and the P-Skip rule) and the
serial pre-pass ``hl_codec_264_decode_avc.c:120-147``.

Two host-side serial passes share one predictor core:
- ``derive_mvs`` (decoder): mvd -> final MVs.
- ``compute_mvds_and_skip`` (encoder): final MVs -> mvd + P-Skip
  eligibility (same neighbor state machine, inverse direction).
"""
from __future__ import annotations

import numpy as np

from portbench.reference.h264.decode.slice_decode import (MB_P16X16, MB_P16X8, MB_P8X16,
                                              MB_P8X8, MB_PBL, MB_PSKIP,
                                              SliceData)


def _median(a, b, c):
    return max(min(a, b), min(max(a, b), c))


class MvPredictor:
    """Progressively-filled MV field with spec 8.4.1.3 prediction."""

    def __init__(self, gw: int, gh: int, mb_slice: np.ndarray):
        self.gw, self.gh = gw, gh
        self.mv_g = np.zeros((4 * gh, 4 * gw, 2), np.int32)
        self.ref_g = np.full((4 * gh, 4 * gw), -1, np.int32)
        self.done = np.zeros((4 * gh, 4 * gw), bool)
        self.mb_slice = mb_slice

    def neighbor(self, bx, by, mbx, mby):
        if bx < 0 or by < 0 or bx >= 4 * self.gw or by >= 4 * self.gh:
            return False, (0, 0), -1
        if self.mb_slice[by >> 2, bx >> 2] != self.mb_slice[mby, mbx]:
            return False, (0, 0), -1
        if not self.done[by, bx]:
            return False, (0, 0), -1
        return True, (int(self.mv_g[by, bx, 0]),
                      int(self.mv_g[by, bx, 1])), int(self.ref_g[by, bx])

    def predict(self, gx4, gy4, w4, h4, ref, mbx, mby, shape):
        aA, mvA, rA = self.neighbor(gx4 - 1, gy4, mbx, mby)
        aB, mvB, rB = self.neighbor(gx4, gy4 - 1, mbx, mby)
        aC, mvC, rC = self.neighbor(gx4 + w4, gy4 - 1, mbx, mby)
        if not aC:
            aC, mvC, rC = self.neighbor(gx4 - 1, gy4 - 1, mbx, mby)
        if shape == "16x8_top" and aB and rB == ref:
            return mvB
        if shape == "16x8_bot" and aA and rA == ref:
            return mvA
        if shape == "8x16_left" and aA and rA == ref:
            return mvA
        if shape == "8x16_right" and aC and rC == ref:
            return mvC
        matches = [(aA and rA == ref), (aB and rB == ref),
                   (aC and rC == ref)]
        if matches == [True, False, False]:
            return mvA
        if matches == [False, True, False]:
            return mvB
        if matches == [False, False, True]:
            return mvC
        if aA and not aB and not aC:
            return mvA
        mA = mvA if aA else (0, 0)
        mB = mvB if aB else (0, 0)
        mC = mvC if aC else (0, 0)
        return (_median(mA[0], mB[0], mC[0]), _median(mA[1], mB[1], mC[1]))

    def pskip_mv(self, mbx, mby):
        """P-Skip MV (8.4.1.1)."""
        x4, y4 = mbx * 4, mby * 4
        aA, mvA, rA = self.neighbor(x4 - 1, y4, mbx, mby)
        aB, mvB, rB = self.neighbor(x4, y4 - 1, mbx, mby)
        if not aA or not aB or \
                (rA == 0 and mvA == (0, 0)) or \
                (rB == 0 and mvB == (0, 0)):
            return (0, 0)
        return self.predict(x4, y4, 4, 4, 0, mbx, mby, "16x16")

    def assign(self, gx4, gy4, w4, h4, mv, ref):
        self.mv_g[gy4:gy4 + h4, gx4:gx4 + w4] = mv
        self.ref_g[gy4:gy4 + h4, gx4:gx4 + w4] = ref
        self.done[gy4:gy4 + h4, gx4:gx4 + w4] = True


def _partition_geometry(kind, sub_types=None):
    """Yields (shape_tag, ref_slot, x4off, y4off, w4, h4, mvd_index) per
    partition, in decode order.  mvd_index = (by, bx) of the stored mvd."""
    if kind == MB_P16X16:
        yield "16x16", 0, 0, 0, 4, 4, (0, 0)
    elif kind == MB_P16X8:
        yield "16x8_top", 0, 0, 0, 4, 2, (0, 0)
        yield "16x8_bot", 2, 0, 2, 4, 2, (2, 0)
    elif kind == MB_P8X16:
        yield "8x16_left", 0, 0, 0, 2, 4, (0, 0)
        yield "8x16_right", 1, 2, 0, 2, 4, (0, 2)
    else:
        raise ValueError


def derive_mvs(sd: SliceData) -> None:
    """Decoder pass: fill sd.mv from sd.mvd (+ skip/intra rules).
    Dispatches to the native C core when available (the serial per-MB
    state machine is a host hot loop at 1080p); ``derive_mvs_py`` is the
    oracle implementation."""
    from portbench.reference.h264 import native
    has_svc = bool((sd.mb_kind == MB_PBL).any()) or \
        (sd.motion_pred_l0 is not None and bool(sd.motion_pred_l0.any()))
    if native.available() and not has_svc:
        sd.mv[:, :] = native.derive_mvs(sd.gw, sd.gh, sd.mb_kind, sd.mvd,
                                        sd.ref_idx, sd.sub_types,
                                        sd.slice_id)
        sd.ref_idx[sd.mb_kind == MB_PSKIP] = 0
        return
    derive_mvs_py(sd)


def derive_mvs_py(sd: SliceData) -> None:
    """Pure-Python oracle for ``derive_mvs``."""
    gh, gw = sd.gh, sd.gw
    P = MvPredictor(gw, gh, sd.slice_id)

    for mby in range(gh):
        for mbx in range(gw):
            kind = int(sd.mb_kind[mby, mbx])
            x4, y4 = mbx * 4, mby * 4
            if kind < 3:
                P.assign(x4, y4, 4, 4, (0, 0), -1)
                continue
            if kind == MB_PSKIP:
                mv = P.pskip_mv(mbx, mby)
                P.assign(x4, y4, 4, 4, mv, 0)
                sd.ref_idx[mby, mbx, :] = 0
                continue
            if kind == MB_PBL:
                # SVC base_mode inter: mv/ref already inferred (G.8.6.1,
                # svc.motion) — load them into the predictor state so
                # they serve as neighbors, nothing to derive
                P.mv_g[y4:y4 + 4, x4:x4 + 4] = sd.mv[mby, mbx]
                ref44 = np.repeat(np.repeat(
                    sd.ref_idx[mby, mbx].reshape(2, 2), 2, 0), 2, 1)
                P.ref_g[y4:y4 + 4, x4:x4 + 4] = ref44
                P.done[y4:y4 + 4, x4:x4 + 4] = True
                continue

            def il_pred(by, bx, slot):
                """motion_prediction_flag_l0: MVP/ref come from the
                inter-layer predictors (stored by the inference pass)."""
                if sd.motion_pred_l0 is None or \
                        not sd.motion_pred_l0[mby, mbx, slot]:
                    return None
                ilmv = getattr(sd, "_il_mv", None)
                ilref = getattr(sd, "_il_ref", None)
                if ilmv is None:
                    raise ValueError("motion_prediction_flag without "
                                     "inter-layer motion state")
                part = (by >> 1) * 2 + (bx >> 1)
                return ((int(ilmv[mby, mbx, by, bx, 0]),
                         int(ilmv[mby, mbx, by, bx, 1])),
                        int(ilref[mby, mbx, part]))

            if kind in (MB_P16X16, MB_P16X8, MB_P8X16):
                for shape, slot, ox, oy, w4, h4, (iy, ix) in \
                        _partition_geometry(kind):
                    ref = int(sd.ref_idx[mby, mbx, slot if kind != MB_P8X16
                                         else slot])
                    ilp = il_pred(iy, ix, slot)
                    if ilp is not None:
                        mvp, ref = ilp
                        sd.ref_idx[mby, mbx, slot] = ref
                    else:
                        mvp = P.predict(x4 + ox, y4 + oy, w4, h4, ref,
                                        mbx, mby, shape)
                    mv = (mvp[0] + int(sd.mvd[mby, mbx, iy, ix, 0]),
                          mvp[1] + int(sd.mvd[mby, mbx, iy, ix, 1]))
                    P.assign(x4 + ox, y4 + oy, w4, h4, mv, ref)
            else:  # P_8x8
                for part in range(4):
                    py, px = (part >> 1) * 2, (part & 1) * 2
                    ref = int(sd.ref_idx[mby, mbx, part])
                    st = int(sd.sub_types[mby, mbx, part])
                    for (ox, oy_, w4, h4) in _sub_geometry(st):
                        gx = x4 + px + ox
                        gy = y4 + py + oy_
                        ilp = il_pred(py + oy_, px + ox, part)
                        if ilp is not None:
                            mvp, ref = ilp
                            sd.ref_idx[mby, mbx, part] = ref
                        else:
                            mvp = P.predict(gx, gy, w4, h4, ref, mbx,
                                            mby, "sub")
                        mv = (mvp[0] + int(sd.mvd[mby, mbx, py + oy_,
                                                  px + ox, 0]),
                              mvp[1] + int(sd.mvd[mby, mbx, py + oy_,
                                                  px + ox, 1]))
                        P.assign(gx, gy, w4, h4, mv, ref)

    sd.mv[:, :] = P.mv_g.reshape(gh, 4, gw, 4, 2).transpose(0, 2, 1, 3, 4)


def _sub_geometry(st):
    if st == 0:
        return [(0, 0, 2, 2)]
    if st == 1:          # 8x4
        return [(0, 0, 2, 1), (0, 1, 2, 1)]
    if st == 2:          # 4x8
        return [(0, 0, 1, 2), (1, 0, 1, 2)]
    return [(0, 0, 1, 1), (1, 0, 1, 1), (0, 1, 1, 1), (1, 1, 1, 1)]


def compute_mvds_and_skip(mb_kind: np.ndarray, mv: np.ndarray,
                          ref_idx: np.ndarray, sub_types: np.ndarray,
                          coded: np.ndarray, slice_id: np.ndarray):
    """Encoder pass: final MVs -> (mvd, skip_ok).  Native C when
    available; ``compute_mvds_and_skip_py`` is the oracle."""
    from portbench.reference.h264 import native
    if native.available():
        gh, gw = mb_kind.shape
        return native.compute_mvds_and_skip(gw, gh, mb_kind, mv, ref_idx,
                                            sub_types, coded, slice_id)
    return compute_mvds_and_skip_py(mb_kind, mv, ref_idx, sub_types,
                                    coded, slice_id)


def compute_mvds_and_skip_py(mb_kind: np.ndarray, mv: np.ndarray,
                             ref_idx: np.ndarray, sub_types: np.ndarray,
                             coded: np.ndarray, slice_id: np.ndarray):
    """Encoder pass: final MVs -> (mvd (gh,gw,4,4,2), skip_ok (gh,gw)).

    ``coded`` (gh,gw) bool: MB has any nonzero coefficients (skip requires
    none).  MBs flagged skip-eligible must then be *treated* as skip by the
    packer (kind 16x16, ref0); their MV must equal the P-Skip MV, which
    this pass verifies (the ME already targets it).
    """
    gh, gw = mb_kind.shape
    P = MvPredictor(gw, gh, slice_id)
    mvd = np.zeros((gh, gw, 4, 4, 2), np.int32)
    skip_ok = np.zeros((gh, gw), bool)

    for mby in range(gh):
        for mbx in range(gw):
            kind = int(mb_kind[mby, mbx])
            x4, y4 = mbx * 4, mby * 4
            if kind < 3:
                P.assign(x4, y4, 4, 4, (0, 0), -1)
                continue
            mv_mb = mv[mby, mbx]                      # (4,4,2) [by][bx]
            if kind == MB_P16X16:
                m = (int(mv_mb[0, 0, 0]), int(mv_mb[0, 0, 1]))
                ref = int(ref_idx[mby, mbx, 0])
                if ref == 0 and not coded[mby, mbx] and \
                        m == P.pskip_mv(mbx, mby):
                    skip_ok[mby, mbx] = True
                mvp = P.predict(x4, y4, 4, 4, ref, mbx, mby, "16x16")
                mvd[mby, mbx, :, :, 0] = m[0] - mvp[0]
                mvd[mby, mbx, :, :, 1] = m[1] - mvp[1]
                P.assign(x4, y4, 4, 4, m, ref)
            elif kind in (MB_P16X8, MB_P8X16):
                for shape, slot, ox, oy, w4, h4, (iy, ix) in \
                        _partition_geometry(kind):
                    ref = int(ref_idx[mby, mbx, slot])
                    m = (int(mv_mb[iy, ix, 0]), int(mv_mb[iy, ix, 1]))
                    mvp = P.predict(x4 + ox, y4 + oy, w4, h4, ref,
                                    mbx, mby, shape)
                    mvd[mby, mbx, iy, ix] = (m[0] - mvp[0], m[1] - mvp[1])
                    P.assign(x4 + ox, y4 + oy, w4, h4, m, ref)
            else:  # P_8x8 (+sub types)
                for part in range(4):
                    py, px = (part >> 1) * 2, (part & 1) * 2
                    ref = int(ref_idx[mby, mbx, part])
                    st = int(sub_types[mby, mbx, part])
                    for (ox, oy_, w4, h4) in _sub_geometry(st):
                        gx = x4 + px + ox
                        gy = y4 + py + oy_
                        m = (int(mv_mb[py + oy_, px + ox, 0]),
                             int(mv_mb[py + oy_, px + ox, 1]))
                        mvp = P.predict(gx, gy, w4, h4, ref, mbx, mby,
                                        "sub")
                        mvd[mby, mbx, py + oy_, px + ox] = \
                            (m[0] - mvp[0], m[1] - mvp[1])
                        P.assign(gx, gy, w4, h4, m, ref)
    return mvd, skip_ok
