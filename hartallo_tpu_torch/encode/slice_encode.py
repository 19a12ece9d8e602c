"""Host-side slice packer: macroblock syntax + CAVLC emission.

Reference parity: ``hl_codec_264_mb.c:543-893`` (_mb_write_no_pcm: mb_type,
intra modes, CBP, QP delta, residual via CAVLC) and
``hl_codec_264_residual.c:587-902`` (write path), restructured to consume
the encoder's dense per-MB arrays (SoA) and run as a pure function per
slice — slices pack independently and concatenate (the reference's
per-slice bitstream design, hl_codec_264_encode.c).
"""
from __future__ import annotations

import numpy as np

from hartallo_tpu_torch.bitio import BitWriter
from hartallo_tpu_torch.core.tables import (CBP_ME_INTRA_INV, CBP_ME_INTER_INV,
                                      LUMA_4x4_BLK_IDX, LUMA_4x4_BLK_XY,
                                      ZIGZAG_4x4)
from hartallo_tpu_torch.entropy.cavlc import write_residual_block

_BLK_X = (LUMA_4x4_BLK_XY[:, 0] // 4).astype(int)
_BLK_Y = (LUMA_4x4_BLK_XY[:, 1] // 4).astype(int)
_ZZ = ZIGZAG_4x4.astype(int)


class FramePacker:
    """Packs one frame's MB data into slice_data bits, maintaining the
    cross-MB prediction state (nnz maps, intra mode prediction, QP)."""

    def __init__(self, gw: int, gh: int, arrays: dict, qp: np.ndarray,
                 mb_kind: np.ndarray):
        self.gw, self.gh = gw, gh
        self.a = arrays              # device outputs converted to numpy
        self.qp = qp
        self.mb_kind = mb_kind       # 0=I4x4, 1=I16, >=3 inter kinds
        self.nnz_luma = np.zeros((4 * gh, 4 * gw), np.int16)
        self.nnz_chroma = np.zeros((2 * gh, 2 * gw, 2), np.int16)
        self.slice_of_mb = np.full((gh, gw), -1, np.int32)

    # -- nC (mirror of SliceDecoder._nc_*) --------------------------------
    def _nc_luma(self, bgx, bgy, sid):
        availA = bgx > 0 and self.slice_of_mb[bgy >> 2, (bgx - 1) >> 2] == sid
        availB = bgy > 0 and self.slice_of_mb[(bgy - 1) >> 2, bgx >> 2] == sid
        if availA and availB:
            return (int(self.nnz_luma[bgy, bgx - 1]) +
                    int(self.nnz_luma[bgy - 1, bgx]) + 1) >> 1
        if availA:
            return int(self.nnz_luma[bgy, bgx - 1])
        if availB:
            return int(self.nnz_luma[bgy - 1, bgx])
        return 0

    def _nc_chroma(self, cgx, cgy, plane, sid):
        availA = cgx > 0 and self.slice_of_mb[cgy >> 1, (cgx - 1) >> 1] == sid
        availB = cgy > 0 and self.slice_of_mb[(cgy - 1) >> 1, cgx >> 1] == sid
        if availA and availB:
            return (int(self.nnz_chroma[cgy, cgx - 1, plane]) +
                    int(self.nnz_chroma[cgy - 1, cgx, plane]) + 1) >> 1
        if availA:
            return int(self.nnz_chroma[cgy, cgx - 1, plane])
        if availB:
            return int(self.nnz_chroma[cgy - 1, cgx, plane])
        return 0

    def _pred_i4_mode(self, mx, my, blk, cur_modes, sid):
        bx, by = _BLK_X[blk], _BLK_Y[blk]
        if bx > 0:
            availA, i4A = True, True
            ma = int(cur_modes[LUMA_4x4_BLK_IDX[by, bx - 1]])
        elif mx > 0 and self.slice_of_mb[my, mx - 1] == sid:
            availA = True
            i4A = self.mb_kind[my, mx - 1] == 0
            ma = int(self.a["i4_modes"][my, mx - 1, LUMA_4x4_BLK_IDX[by, 3]])
        else:
            availA, i4A, ma = False, False, 2
        if by > 0:
            availB, i4B = True, True
            mb = int(cur_modes[LUMA_4x4_BLK_IDX[by - 1, bx]])
        elif my > 0 and self.slice_of_mb[my - 1, mx] == sid:
            availB = True
            i4B = self.mb_kind[my - 1, mx] == 0
            mb = int(self.a["i4_modes"][my - 1, mx, LUMA_4x4_BLK_IDX[3, bx]])
        else:
            availB, i4B, mb = False, False, 2
        if not availA or not availB:
            return 2
        return min(ma if i4A else 2, mb if i4B else 2)

    # -- coded block pattern from coefficients ----------------------------
    def _derive_cbp(self, mx, my, i16: bool):
        ac = self.a["luma_ac"][my, mx]          # (16,4,4)
        if i16:
            cbp_luma = 15 if ac.any() else 0
        else:
            cbp_luma = 0
            for g in range(4):
                blks = [g * 4 + k for k in range(4)]
                if any(ac[b].any() for b in blks):
                    cbp_luma |= 1 << g
        cdc = self.a["chroma_dc"][my, mx]
        cac = self.a["chroma_ac"][my, mx]
        if cac.any():
            cbp_chroma = 2
        elif cdc.any():
            cbp_chroma = 1
        else:
            cbp_chroma = 0
        return cbp_luma, cbp_chroma

    # -- residual emission ------------------------------------------------
    def _write_luma(self, w, mx, my, i16, cbp_luma, sid):
        a = self.a
        if i16:
            nc = self._nc_luma(mx * 4, my * 4, sid)
            dc_scan = a["luma_dc"][my, mx].ravel()[_ZZ]
            write_residual_block(w, dc_scan, nc, 16)
        for blk in range(16):
            bx, by = _BLK_X[blk], _BLK_Y[blk]
            bgx, bgy = mx * 4 + bx, my * 4 + by
            if not (cbp_luma & (1 << (blk >> 2))):
                self.nnz_luma[bgy, bgx] = 0
                continue
            nc = self._nc_luma(bgx, bgy, sid)
            coefs = a["luma_ac"][my, mx, blk].ravel()
            if i16:
                tc = write_residual_block(w, coefs[_ZZ[1:]], nc, 15)
            else:
                tc = write_residual_block(w, coefs[_ZZ], nc, 16)
            self.nnz_luma[bgy, bgx] = tc

    def _write_chroma(self, w, mx, my, cbp_chroma, sid):
        a = self.a
        if cbp_chroma == 0:
            self.nnz_chroma[my * 2:my * 2 + 2, mx * 2:mx * 2 + 2, :] = 0
            return
        for plane in range(2):
            write_residual_block(w, a["chroma_dc"][my, mx, plane].ravel(),
                                 -1, 4)
        if cbp_chroma == 2:
            for plane in range(2):
                for blk in range(4):
                    bx, by = blk & 1, blk >> 1
                    cgx, cgy = mx * 2 + bx, my * 2 + by
                    nc = self._nc_chroma(cgx, cgy, plane, sid)
                    coefs = a["chroma_ac"][my, mx, plane, blk].ravel()
                    tc = write_residual_block(w, coefs[_ZZ[1:]], nc, 15)
                    self.nnz_chroma[cgy, cgx, plane] = tc
        else:
            self.nnz_chroma[my * 2:my * 2 + 2, mx * 2:mx * 2 + 2, :] = 0

    # -- macroblock -------------------------------------------------------
    def write_i_mb(self, w: BitWriter, mx: int, my: int, qp_state: list,
                   sid: int, slice_is_p: bool = False) -> None:
        a = self.a
        self.slice_of_mb[my, mx] = sid
        i16 = bool(a["use_i16"][my, mx])
        cbp_luma, cbp_chroma = self._derive_cbp(mx, my, i16)
        if i16:
            m = int(a["i16_mode"][my, mx]) + cbp_chroma * 4 + \
                (12 if cbp_luma else 0)
            mb_type = 1 + m
        else:
            mb_type = 0
        w.ue(mb_type + (5 if slice_is_p else 0))
        if not i16:
            cur = a["i4_modes"][my, mx]
            for blk in range(16):
                pred = self._pred_i4_mode(mx, my, blk, cur, sid)
                mode = int(cur[blk])
                if mode == pred:
                    w.u1(1)
                else:
                    w.u1(0)
                    w.u(mode if mode < pred else mode - 1, 3)
            w.ue(int(a["chroma_mode"][my, mx]))
            w.ue(int(CBP_ME_INTRA_INV[cbp_luma | (cbp_chroma << 4)]))
        else:
            w.ue(int(a["chroma_mode"][my, mx]))
        if cbp_luma or cbp_chroma or i16:
            delta = int(self.qp[my, mx]) - qp_state[0]
            w.se(delta)
            qp_state[0] = int(self.qp[my, mx])
        if i16 or cbp_luma:
            self._write_luma(w, mx, my, i16, cbp_luma, sid)
        else:
            self.nnz_luma[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0
        self._write_chroma(w, mx, my, cbp_chroma, sid)

    # -- SVC I_BL macroblock (base_mode_flag=1 via slice default) ---------
    def write_ibl_mb(self, w: BitWriter, mx: int, my: int,
                     qp_state: list, sid: int) -> None:
        self.slice_of_mb[my, mx] = sid
        cbp_luma, cbp_chroma = self._derive_cbp(mx, my, False)
        w.ue(int(CBP_ME_INTER_INV[cbp_luma | (cbp_chroma << 4)]))
        if cbp_luma or cbp_chroma:
            delta = int(self.qp[my, mx]) - qp_state[0]
            w.se(delta)
            qp_state[0] = int(self.qp[my, mx])
        if cbp_luma:
            self._write_luma(w, mx, my, False, cbp_luma, sid)
        else:
            self.nnz_luma[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0
        self._write_chroma(w, mx, my, cbp_chroma, sid)

    # -- P macroblocks ----------------------------------------------------
    def mark_skip(self, mx: int, my: int, sid: int) -> None:
        self.slice_of_mb[my, mx] = sid
        self.nnz_luma[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0
        self.nnz_chroma[my * 2:my * 2 + 2, mx * 2:mx * 2 + 2, :] = 0

    def write_p_mb(self, w: BitWriter, mx: int, my: int, qp_state: list,
                   sid: int, mvd: np.ndarray, num_ref: int = 1) -> None:
        """mvd: (gh,gw,4,4,2) from compute_mvds_and_skip."""
        from hartallo_tpu_torch.decode.slice_decode import (MB_P16X16, MB_P16X8,
                                                      MB_P8X16, MB_P8X8)
        a = self.a
        self.slice_of_mb[my, mx] = sid
        kind = int(self.mb_kind[my, mx])
        mb_type = {MB_P16X16: 0, MB_P16X8: 1, MB_P8X16: 2, MB_P8X8: 3}[kind]
        w.ue(mb_type)
        refs = a["ref_idx"][my, mx]
        d = mvd[my, mx]

        def wref(slot):
            if num_ref > 1:
                w.te(int(refs[slot]), num_ref - 1)

        if kind == MB_P16X16:
            wref(0)
            w.se(int(d[0, 0, 0]))
            w.se(int(d[0, 0, 1]))
        elif kind == MB_P16X8:
            wref(0)
            wref(2)
            for iy in (0, 2):
                w.se(int(d[iy, 0, 0]))
                w.se(int(d[iy, 0, 1]))
        elif kind == MB_P8X16:
            wref(0)
            wref(1)
            for ix in (0, 2):
                w.se(int(d[0, ix, 0]))
                w.se(int(d[0, ix, 1]))
        else:  # P_8x8
            subs = a["sub_types"][my, mx]
            for part in range(4):
                w.ue(int(subs[part]))
            for part in range(4):
                wref(part)
            from hartallo_tpu_torch.decode.mv import _sub_geometry
            for part in range(4):
                py, px = (part >> 1) * 2, (part & 1) * 2
                for (ox, oy_, w4, h4) in _sub_geometry(int(subs[part])):
                    w.se(int(d[py + oy_, px + ox, 0]))
                    w.se(int(d[py + oy_, px + ox, 1]))

        cbp_luma, cbp_chroma = self._derive_cbp(mx, my, False)
        w.ue(int(CBP_ME_INTER_INV[cbp_luma | (cbp_chroma << 4)]))
        if cbp_luma or cbp_chroma:
            delta = int(self.qp[my, mx]) - qp_state[0]
            w.se(delta)
            qp_state[0] = int(self.qp[my, mx])
        if cbp_luma:
            self._write_luma(w, mx, my, False, cbp_luma, sid)
        else:
            self.nnz_luma[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0
        self._write_chroma(w, mx, my, cbp_chroma, sid)
