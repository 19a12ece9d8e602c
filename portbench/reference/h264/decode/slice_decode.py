"""Host-side slice_data parse: the serial CAVLC/syntax loop over macroblocks.

Reference parity: ``hl_codec_264_slice.c:1011-1671`` (slice_data_decode MB
loop: skip-run, macroblock_layer, mb_pred/sub_mb_pred, residual_read) and
``hl_codec_264_residual.c:47-279`` (block scan order + nC derivation
``:439-455``).

The parse produces dense per-MB tensors (SoA) that the device pixel pipeline
consumes — no per-MB objects (SURVEY.md §7 design stance).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from portbench.reference.h264.bitio import BitReader
from portbench.reference.h264.core.tables import (
    CBP_ME_INTER, CBP_ME_INTRA, LUMA_4x4_BLK_XY, ZIGZAG_4x4,
    P_MB_PART, P_SUB_MB_PART,
)
from portbench.reference.h264.decode.params import PPS, SPS
from portbench.reference.h264.decode.sliceheader import SliceHeader
from portbench.reference.h264.entropy.cavlc import read_residual_block

# mb_type encodings used in the dense arrays
MB_I4X4 = 0
MB_I16 = 1
MB_PCM = 2
MB_PSKIP = 3
MB_P16X16 = 4
MB_P16X8 = 5
MB_P8X16 = 6
MB_P8X8 = 7          # includes P_8x8ref0
MB_IBL = 8           # SVC I_BL (base_mode_flag, inter-layer intra)
MB_PBL = 9           # SVC inferred inter (base_mode_flag in EP slices,
                     # G.8.6.1 motion inference; mv/ref filled by
                     # svc.motion.infer_inter_layer_motion)


@dataclass
class SliceData:
    """Dense per-MB state for one decoded picture (single layer)."""
    gw: int                      # MBs per row
    gh: int                      # MB rows
    mb_kind: np.ndarray          # (gh,gw) int8: MB_* above, -1 = not decoded
    qp: np.ndarray               # (gh,gw) int8 luma QP per MB
    i16_mode: np.ndarray         # (gh,gw) int8
    i4_modes: np.ndarray         # (gh,gw,16) int8, blk order = spec blkIdx
    chroma_mode: np.ndarray      # (gh,gw) int8
    cbp_luma: np.ndarray         # (gh,gw) uint8
    cbp_chroma: np.ndarray       # (gh,gw) uint8
    # coefficients in RASTER position within each 4x4 block
    luma_ac: np.ndarray          # (gh,gw,16,4,4) int32, blkIdx-major
    luma_dc: np.ndarray          # (gh,gw,4,4) int32 (I16 DC)
    chroma_dc: np.ndarray        # (gh,gw,2,2,2) int32 [plane]
    chroma_ac: np.ndarray        # (gh,gw,2,4,4,4) int32 [plane][blkIdx]
    nnz_luma: np.ndarray         # (4gh,4gw) int16 TotalCoeff map
    nnz_chroma: np.ndarray       # (2gh,2gw,2) int16
    pcm_luma: np.ndarray         # (gh,gw,16,16) uint8
    pcm_chroma: np.ndarray       # (gh,gw,2,8,8) uint8
    slice_id: np.ndarray         # (gh,gw) int32, -1 = not decoded
    # inter fields
    mv: np.ndarray               # (gh,gw,4,4,2) int32 quarter-pel L0 MVs
    mvd: np.ndarray              # (gh,gw,4,4,2) int32 parsed MV deltas
    ref_idx: np.ndarray          # (gh,gw,4) int8 per 8x8 partition
    sub_types: np.ndarray        # (gh,gw,4) int8 P sub_mb_type (P_8x8 only)
    num_ref_idx_active: np.ndarray = None   # (gh,gw) int8 (slice's l0 count)
    # per-MB deblock parameters (from the MB's slice header)
    deblock_idc: np.ndarray = None      # (gh,gw) int8, default 1 (off)
    alpha_off: np.ndarray = None        # (gh,gw) int8 (2*div2)
    beta_off: np.ndarray = None         # (gh,gw) int8
    # SVC per-MB flags (G.7.3.6)
    res_pred: np.ndarray = None         # (gh,gw) int8 residual_prediction
    motion_pred_l0: np.ndarray = None   # (gh,gw,4) int8 per partition
    # transient parse state
    _slice_count: int = 0
    # per-slice explicit weighted-prediction tables (sid -> PredWeightTable
    # or None); applied per MB via slice_id at reconstruction time
    wp: dict = field(default_factory=dict)

    @classmethod
    def create(cls, gw: int, gh: int) -> "SliceData":
        return cls(
            gw=gw, gh=gh,
            mb_kind=np.full((gh, gw), -1, np.int8),
            qp=np.zeros((gh, gw), np.int8),
            i16_mode=np.zeros((gh, gw), np.int8),
            i4_modes=np.full((gh, gw, 16), 2, np.int8),
            chroma_mode=np.zeros((gh, gw), np.int8),
            cbp_luma=np.zeros((gh, gw), np.uint8),
            cbp_chroma=np.zeros((gh, gw), np.uint8),
            luma_ac=np.zeros((gh, gw, 16, 4, 4), np.int32),
            luma_dc=np.zeros((gh, gw, 4, 4), np.int32),
            chroma_dc=np.zeros((gh, gw, 2, 2, 2), np.int32),
            chroma_ac=np.zeros((gh, gw, 2, 4, 4, 4), np.int32),
            nnz_luma=np.zeros((4 * gh, 4 * gw), np.int16),
            nnz_chroma=np.zeros((2 * gh, 2 * gw, 2), np.int16),
            pcm_luma=np.zeros((gh, gw, 16, 16), np.uint8),
            pcm_chroma=np.zeros((gh, gw, 2, 8, 8), np.uint8),
            slice_id=np.full((gh, gw), -1, np.int32),
            mv=np.zeros((gh, gw, 4, 4, 2), np.int32),
            mvd=np.zeros((gh, gw, 4, 4, 2), np.int32),
            ref_idx=np.zeros((gh, gw, 4), np.int8),
            sub_types=np.zeros((gh, gw, 4), np.int8),
            num_ref_idx_active=np.ones((gh, gw), np.int8),
            deblock_idc=np.ones((gh, gw), np.int8),
            alpha_off=np.zeros((gh, gw), np.int8),
            beta_off=np.zeros((gh, gw), np.int8),
            res_pred=np.zeros((gh, gw), np.int8),
            motion_pred_l0=np.zeros((gh, gw, 4), np.int8),
        )


# block positions: luma blkIdx -> (bx, by) in 4-pel units inside the MB
_BLK_X = (LUMA_4x4_BLK_XY[:, 0] // 4).astype(np.int64)
_BLK_Y = (LUMA_4x4_BLK_XY[:, 1] // 4).astype(np.int64)
# inverse zigzag scatter: coeff i (scan order) -> raster position
_ZZ_POS = ZIGZAG_4x4.astype(np.int64)


def _unzigzag16(levels: np.ndarray) -> np.ndarray:
    out = np.zeros(16, dtype=np.int32)
    out[_ZZ_POS] = levels
    return out.reshape(4, 4)


def _unzigzag15(levels15: np.ndarray) -> np.ndarray:
    """AC-only block: scan positions 1..15."""
    out = np.zeros(16, dtype=np.int32)
    out[_ZZ_POS[1:]] = levels15[:15]
    return out.reshape(4, 4)


class SliceDecoder:
    """Parses slice_data() for I/P slices into a SliceData SoA."""

    def __init__(self, sps: SPS, pps: PPS, sd: SliceData):
        self.sps = sps
        self.pps = pps
        self.sd = sd

    # -- nC derivation (spec 9.2.1; reference residual.c:439-455) ---------
    def _nc_luma(self, bgx: int, bgy: int, sid: int) -> int:
        """bgx/bgy: global 4x4 block coords; sid: current slice id."""
        sd = self.sd
        availA = bgx > 0 and sd.slice_id[bgy >> 2, (bgx - 1) >> 2] == sid
        availB = bgy > 0 and sd.slice_id[(bgy - 1) >> 2, bgx >> 2] == sid
        if availA and availB:
            return (int(sd.nnz_luma[bgy, bgx - 1]) +
                    int(sd.nnz_luma[bgy - 1, bgx]) + 1) >> 1
        if availA:
            return int(sd.nnz_luma[bgy, bgx - 1])
        if availB:
            return int(sd.nnz_luma[bgy - 1, bgx])
        return 0

    def _nc_chroma(self, cgx: int, cgy: int, plane: int, sid: int) -> int:
        sd = self.sd
        availA = cgx > 0 and sd.slice_id[cgy >> 1, (cgx - 1) >> 1] == sid
        availB = cgy > 0 and sd.slice_id[(cgy - 1) >> 1, cgx >> 1] == sid
        if availA and availB:
            return (int(sd.nnz_chroma[cgy, cgx - 1, plane]) +
                    int(sd.nnz_chroma[cgy - 1, cgx, plane]) + 1) >> 1
        if availA:
            return int(sd.nnz_chroma[cgy, cgx - 1, plane])
        if availB:
            return int(sd.nnz_chroma[cgy - 1, cgx, plane])
        return 0

    # -- intra mode prediction (spec 8.3.1.1) -----------------------------
    def _pred_intra4x4_mode(self, mx: int, my: int, blk: int,
                            cur_modes: np.ndarray, sid: int) -> int:
        sd = self.sd
        bx, by = int(_BLK_X[blk]), int(_BLK_Y[blk])
        # block A (left)
        if bx > 0:
            ma = int(cur_modes[int(_blk_idx(bx - 1, by))])
            availA, i4A = True, sd.mb_kind[my, mx] == MB_I4X4
        elif mx > 0 and sd.slice_id[my, mx - 1] == sid:
            availA = True
            i4A = sd.mb_kind[my, mx - 1] == MB_I4X4
            ma = int(sd.i4_modes[my, mx - 1, int(_blk_idx(3, by))])
        else:
            availA, i4A, ma = False, False, 2
        # block B (top)
        if by > 0:
            mb = int(cur_modes[int(_blk_idx(bx, by - 1))])
            availB, i4B = True, sd.mb_kind[my, mx] == MB_I4X4
        elif my > 0 and sd.slice_id[my - 1, mx] == sid:
            availB = True
            i4B = sd.mb_kind[my - 1, mx] == MB_I4X4
            mb = int(sd.i4_modes[my - 1, mx, int(_blk_idx(bx, 3))])
        else:
            availB, i4B, mb = False, False, 2
        if not availA or not availB:
            return 2  # DC
        pa = ma if i4A else 2
        pb = mb if i4B else 2
        return min(pa, pb)

    # -- residual parsing -------------------------------------------------
    def _read_luma_residual(self, r: BitReader, mx: int, my: int,
                            i16: bool, cbp_luma: int, sid: int) -> None:
        sd = self.sd
        if i16:
            nc = self._nc_luma(mx * 4, my * 4, sid)
            levels, _ = read_residual_block(r, nc, 16)
            sd.luma_dc[my, mx] = _unzigzag16(levels)
        for blk in range(16):
            bx, by = int(_BLK_X[blk]), int(_BLK_Y[blk])
            bgx, bgy = mx * 4 + bx, my * 4 + by
            if not (cbp_luma & (1 << (blk >> 2))):
                sd.nnz_luma[bgy, bgx] = 0
                continue
            nc = self._nc_luma(bgx, bgy, sid)
            if i16:
                levels, tc = read_residual_block(r, nc, 15)
                sd.luma_ac[my, mx, blk] = _unzigzag15(levels)
            else:
                levels, tc = read_residual_block(r, nc, 16)
                sd.luma_ac[my, mx, blk] = _unzigzag16(levels)
            sd.nnz_luma[bgy, bgx] = tc

    def _read_chroma_residual(self, r: BitReader, mx: int, my: int,
                              cbp_chroma: int, sid: int) -> None:
        sd = self.sd
        if cbp_chroma == 0:
            return
        for plane in range(2):
            levels, _ = read_residual_block(r, -1, 4)
            sd.chroma_dc[my, mx, plane] = levels.reshape(2, 2)
        if cbp_chroma == 2:
            for plane in range(2):
                for blk in range(4):
                    bx, by = blk & 1, blk >> 1
                    cgx, cgy = mx * 2 + bx, my * 2 + by
                    nc = self._nc_chroma(cgx, cgy, plane, sid)
                    levels, tc = read_residual_block(r, nc, 15)
                    sd.chroma_ac[my, mx, plane, blk] = _unzigzag15(levels)
                    sd.nnz_chroma[cgy, cgx, plane] = tc

    # -- macroblock_layer for intra kinds ---------------------------------
    def _parse_i_mb(self, r: BitReader, mx: int, my: int, mb_type_i: int,
                    qp_state: list, sid: int) -> None:
        sd = self.sd
        sd.slice_id[my, mx] = sid
        if mb_type_i == 25:  # I_PCM
            sd.mb_kind[my, mx] = MB_PCM
            while not r.byte_aligned():
                r.u1()
            y = np.array([r.u(8) for _ in range(256)],
                         np.uint8).reshape(16, 16)
            sd.pcm_luma[my, mx] = y
            for plane in range(2):
                c = np.array([r.u(8) for _ in range(64)],
                             np.uint8).reshape(8, 8)
                sd.pcm_chroma[my, mx, plane] = c
            sd.nnz_luma[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 16
            sd.nnz_chroma[my * 2:my * 2 + 2, mx * 2:mx * 2 + 2, :] = 16
            sd.qp[my, mx] = qp_state[0]
            return
        if mb_type_i == 0:   # I_4x4
            sd.mb_kind[my, mx] = MB_I4X4
            cur = np.full(16, 2, np.int8)
            for blk in range(16):
                pred = self._pred_intra4x4_mode(mx, my, blk, cur, sid)
                if r.u1():
                    cur[blk] = pred
                else:
                    rem = r.u(3)
                    cur[blk] = rem if rem < pred else rem + 1
            sd.i4_modes[my, mx] = cur
            sd.chroma_mode[my, mx] = r.ue()
            code = r.ue()
            if code > 47:
                raise ValueError("invalid cbp codeNum")
            cbp = int(CBP_ME_INTRA[code])
            cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        else:                # I_16x16
            sd.mb_kind[my, mx] = MB_I16
            m = mb_type_i - 1
            sd.i16_mode[my, mx] = m & 3
            cbp_chroma = (m >> 2) % 3
            cbp_luma = 15 if m >= 12 else 0
            sd.chroma_mode[my, mx] = r.ue()
        sd.cbp_luma[my, mx] = cbp_luma
        sd.cbp_chroma[my, mx] = cbp_chroma
        if cbp_luma or cbp_chroma or sd.mb_kind[my, mx] == MB_I16:
            delta = r.se()
            qp_state[0] = (qp_state[0] + delta + 52) % 52
        sd.qp[my, mx] = qp_state[0]
        i16 = sd.mb_kind[my, mx] == MB_I16
        if i16 or cbp_luma:
            self._read_luma_residual(r, mx, my, i16, cbp_luma, sid)
        else:
            sd.nnz_luma[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0
        self._read_chroma_residual(r, mx, my, cbp_chroma, sid)

    # -- slice data -------------------------------------------------------
    def decode_slice_data(self, r: BitReader, hdr: SliceHeader,
                          ref_planes=None, svc_inter_layer: bool = False,
                          scan_order=None) -> None:
        """Parse all MBs of one slice (I or P, CAVLC).  When
        ``svc_inter_layer`` the SVC MB syntax (base_mode_flag, G.7.3.6)
        is in effect and the Python path is used.

        ``scan_order``: FMO MB-address visit order (NextMbAddress walk of
        the slice group, 8.2.2 / hl_codec_264_fmo.c) — when None, MBs are
        visited in raster order from first_mb_in_slice.
        """
        sd = self.sd
        sid = sd._slice_count
        sd._slice_count += 1
        qp_state = [hdr.slice_qp(self.pps)]
        n_mbs = sd.gw * sd.gh
        is_p = hdr.is_p
        self._num_ref_idx_active = hdr.num_ref_idx_l0_active_minus1 + 1
        if scan_order is None:
            order = range(hdr.first_mb_in_slice, n_mbs)
        else:
            order = [int(a) for a in scan_order]

        from portbench.reference.h264 import native
        if native.available() and not svc_inter_layer \
                and scan_order is None:
            n, _ = native.parse_slice_data(
                r.data, r.pos, sd, first_mb=hdr.first_mb_in_slice,
                slice_qp=qp_state[0],
                is_p=is_p, num_ref=self._num_ref_idx_active, sid=sid,
                deblock_idc=hdr.disable_deblocking_filter_idc,
                alpha_off=2 * hdr.slice_alpha_c0_offset_div2,
                beta_off=2 * hdr.slice_beta_offset_div2)
            if n < 0:
                raise ValueError(f"native slice parse failed ({n})")
            return

        def mark_deblock(mx, my):
            sd.deblock_idc[my, mx] = hdr.disable_deblocking_filter_idc
            sd.alpha_off[my, mx] = 2 * hdr.slice_alpha_c0_offset_div2
            sd.beta_off[my, mx] = 2 * hdr.slice_beta_offset_div2

        order_it = iter(order)

        def next_addr():
            return next(order_it, None)

        while True:
            if not r.more_rbsp_data():
                break
            addr = next_addr()
            if addr is None:
                break
            mx, my = addr % sd.gw, addr // sd.gw
            if is_p:
                skip_run = r.ue()
                for _ in range(skip_run):
                    if addr is None:
                        raise ValueError("skip run overflow")
                    mx, my = addr % sd.gw, addr // sd.gw
                    sd.mb_kind[my, mx] = MB_PSKIP
                    sd.slice_id[my, mx] = sid
                    sd.qp[my, mx] = qp_state[0]
                    mark_deblock(mx, my)
                    sd.nnz_luma[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0
                    sd.nnz_chroma[my * 2:my * 2 + 2,
                                  mx * 2:mx * 2 + 2, :] = 0
                    addr = next_addr()
                if addr is None or not r.more_rbsp_data():
                    break
                mx, my = addr % sd.gw, addr // sd.gw
                base_mode = 0
                if svc_inter_layer:
                    # G.7.3.6.* EP macroblock layer: base_mode_flag first
                    if hdr.adaptive_base_mode_flag:
                        base_mode = r.u1()
                    else:
                        base_mode = hdr.default_base_mode_flag
                if base_mode:
                    self._parse_pbl_mb(r, hdr, mx, my, qp_state, sid)
                else:
                    mb_type = r.ue()
                    if mb_type < 5:
                        self._parse_p_mb(r, mx, my, mb_type, qp_state,
                                         sid, hdr=hdr if svc_inter_layer
                                         else None)
                    else:
                        self._parse_i_mb(r, mx, my, mb_type - 5,
                                         qp_state, sid)
                mark_deblock(mx, my)
            else:
                base_mode = 0
                if svc_inter_layer:
                    if hdr.adaptive_base_mode_flag:
                        base_mode = r.u1()
                    else:
                        base_mode = hdr.default_base_mode_flag
                if base_mode:
                    self._parse_ibl_mb(r, mx, my, qp_state, sid)
                else:
                    mb_type = r.ue()
                    self._parse_i_mb(r, mx, my, mb_type, qp_state, sid)
                mark_deblock(mx, my)

    # -- SVC I_BL macroblock (spec G.7.3.6: base_mode_flag=1, intra) ------
    def _parse_ibl_mb(self, r: BitReader, mx: int, my: int,
                      qp_state: list, sid: int) -> None:
        sd = self.sd
        sd.slice_id[my, mx] = sid
        sd.mb_kind[my, mx] = MB_IBL
        code = r.ue()
        if code > 47:
            raise ValueError("invalid cbp codeNum")
        cbp = int(CBP_ME_INTER[code])
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        sd.cbp_luma[my, mx] = cbp_luma
        sd.cbp_chroma[my, mx] = cbp_chroma
        if cbp_luma or cbp_chroma:
            delta = r.se()
            qp_state[0] = (qp_state[0] + delta + 52) % 52
        sd.qp[my, mx] = qp_state[0]
        if cbp_luma:
            self._read_luma_residual(r, mx, my, False, cbp_luma, sid)
        else:
            sd.nnz_luma[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0
        self._read_chroma_residual(r, mx, my, cbp_chroma, sid)

    # -- SVC inferred inter MB (G.7.3.6: base_mode_flag=1 in EP) ----------
    def _parse_pbl_mb(self, r: BitReader, hdr, mx: int, my: int,
                      qp_state: list, sid: int) -> None:
        """EP-slice macroblock with base_mode_flag=1: no mb_type/mvd —
        motion is inferred from the reference layer (G.8.6.1, applied
        later by the decoder's inference pass); syntax is
        residual_prediction_flag? + CBP + residual (G.7.3.6.2).  The MB
        kind may be flipped to MB_IBL by the inference pass when the
        co-located reference-layer MB is intra."""
        sd = self.sd
        sd.slice_id[my, mx] = sid
        sd.mb_kind[my, mx] = MB_PBL
        sd.num_ref_idx_active[my, mx] = self._num_ref_idx_active
        if hdr.adaptive_residual_prediction_flag:
            sd.res_pred[my, mx] = r.u1()
        else:
            sd.res_pred[my, mx] = hdr.default_residual_prediction_flag
        code = r.ue()
        if code > 47:
            raise ValueError("invalid cbp codeNum")
        cbp = int(CBP_ME_INTER[code])
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        sd.cbp_luma[my, mx] = cbp_luma
        sd.cbp_chroma[my, mx] = cbp_chroma
        if cbp_luma or cbp_chroma:
            delta = r.se()
            qp_state[0] = (qp_state[0] + delta + 52) % 52
        sd.qp[my, mx] = qp_state[0]
        if cbp_luma:
            self._read_luma_residual(r, mx, my, False, cbp_luma, sid)
        else:
            sd.nnz_luma[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0
        self._read_chroma_residual(r, mx, my, cbp_chroma, sid)

    # -- P macroblocks ----------------------------------------------------
    def _parse_p_mb(self, r: BitReader, mx: int, my: int, mb_type: int,
                    qp_state: list, sid: int, hdr=None) -> None:
        """mb_pred/sub_mb_pred syntax (spec 7.3.5.1/7.3.5.2, P slices):
        raw ref_idx + mvd are stored; final MVs come from the MV
        derivation pass (decode/mv.py, spec 8.4.1)."""
        sd = self.sd
        sd.slice_id[my, mx] = sid
        kind = (MB_P16X16, MB_P16X8, MB_P8X16, MB_P8X8, MB_P8X8)[mb_type]
        sd.mb_kind[my, mx] = kind
        nra = int(self._num_ref_idx_active)
        sd.num_ref_idx_active[my, mx] = nra
        ref_range = nra - 1

        # G.7.3.6.1/.2: per-partition motion_prediction_flag_l0 precedes
        # the ref_idx reads (which are absent for flagged partitions)
        adaptive_mp = hdr is not None and \
            bool(hdr.adaptive_motion_prediction_flag)

        def read_mp(nparts):
            if not adaptive_mp:
                return [0] * nparts
            return [r.u1() for _ in range(nparts)]

        def read_ref(mp=0):
            if mp:
                return 0           # inferred later (refIdxILPred)
            return r.te(ref_range) if ref_range > 0 else 0

        if kind == MB_P16X16:
            mp = read_mp(1)
            sd.motion_pred_l0[my, mx, :] = mp[0]
            ref = read_ref(mp[0])
            sd.ref_idx[my, mx, :] = ref
            mvd = (r.se(), r.se())
            sd.mvd[my, mx, :, :, 0] = mvd[0]
            sd.mvd[my, mx, :, :, 1] = mvd[1]
        elif kind in (MB_P16X8, MB_P8X16):
            mp = read_mp(2)
            if kind == MB_P16X8:
                sd.motion_pred_l0[my, mx, 0:2] = mp[0]
                sd.motion_pred_l0[my, mx, 2:4] = mp[1]
            else:
                sd.motion_pred_l0[my, mx, 0::2] = mp[0]
                sd.motion_pred_l0[my, mx, 1::2] = mp[1]
            refs = [read_ref(mp[0]), read_ref(mp[1])]
            mvds = [(r.se(), r.se()), (r.se(), r.se())]
            if kind == MB_P16X8:
                sd.ref_idx[my, mx, 0:2] = refs[0]
                sd.ref_idx[my, mx, 2:4] = refs[1]
                for p, (dx, dy) in enumerate(mvds):
                    sd.mvd[my, mx, p * 2:p * 2 + 2, :, 0] = dx
                    sd.mvd[my, mx, p * 2:p * 2 + 2, :, 1] = dy
            else:
                sd.ref_idx[my, mx, 0::2] = refs[0]
                sd.ref_idx[my, mx, 1::2] = refs[1]
                for p, (dx, dy) in enumerate(mvds):
                    sd.mvd[my, mx, :, p * 2:p * 2 + 2, 0] = dx
                    sd.mvd[my, mx, :, p * 2:p * 2 + 2, 1] = dy
        else:  # P_8x8 / P_8x8ref0
            subs = [r.ue() for _ in range(4)]
            if any(s > 3 for s in subs):
                raise ValueError("invalid P sub_mb_type")
            sd.sub_types[my, mx] = subs
            mp = read_mp(4)
            sd.motion_pred_l0[my, mx, :] = mp
            if mb_type == 4:  # P_8x8ref0
                refs = [0, 0, 0, 0]
            else:
                refs = [read_ref(mp[p]) for p in range(4)]
            sd.ref_idx[my, mx, :] = refs
            for part in range(4):
                py, px = (part >> 1) * 2, (part & 1) * 2
                st = subs[part]
                nsub, sw4, sh4 = (int(P_SUB_MB_PART[st, 0]),
                                  int(P_SUB_MB_PART[st, 1]) // 4,
                                  int(P_SUB_MB_PART[st, 2]) // 4)
                for sub in range(nsub):
                    if st == 1:        # 8x4: subs stacked vertically
                        sy, sx = py + sub, px
                    elif st == 2:      # 4x8: side by side
                        sy, sx = py, px + sub
                    elif st == 3:      # 4x4 raster
                        sy, sx = py + (sub >> 1), px + (sub & 1)
                    else:
                        sy, sx = py, px
                    dx, dy = r.se(), r.se()
                    sd.mvd[my, mx, sy:sy + sh4, sx:sx + sw4, 0] = dx
                    sd.mvd[my, mx, sy:sy + sh4, sx:sx + sw4, 1] = dy

        # G.7.3.6.2: residual_prediction_flag for inter MBs in EP slices
        if hdr is not None and hdr.adaptive_residual_prediction_flag:
            sd.res_pred[my, mx] = r.u1()

        # coded_block_pattern + residual
        code = r.ue()
        if code > 47:
            raise ValueError("invalid cbp codeNum")
        cbp = int(CBP_ME_INTER[code])
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        sd.cbp_luma[my, mx] = cbp_luma
        sd.cbp_chroma[my, mx] = cbp_chroma
        if cbp_luma or cbp_chroma:
            delta = r.se()
            qp_state[0] = (qp_state[0] + delta + 52) % 52
        sd.qp[my, mx] = qp_state[0]
        if cbp_luma:
            self._read_luma_residual(r, mx, my, False, cbp_luma, sid)
        else:
            sd.nnz_luma[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0
        self._read_chroma_residual(r, mx, my, cbp_chroma, sid)


def _blk_idx(bx: int, by: int) -> int:
    from portbench.reference.h264.core.tables import LUMA_4x4_BLK_IDX
    return int(LUMA_4x4_BLK_IDX[by, bx])
