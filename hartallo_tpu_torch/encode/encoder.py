"""Single-layer AVC encoder front end (torch): GOP control, parameter sets,
the device encode programs of ``e_device``, host CAVLC packing, and the
deblocked recon kept on the device as the next picture's reference.

Port of class ``Encoder`` of ``hartallo_tpu/encode/encoder.py`` (reference
``hl_codec_264.c:404-1104`` and ``hl_codec_264_encode.c``).  The host code
is the port's copy of the JAX package's host modules: parameter sets,
slice headers, NAL writing, ``FramePacker`` and ``native`` (CAVLC), MVD
and skip derivation, FMO maps and ``RateControl``.  The hooks of the SVC
encoder (``encode/svc.py``) are here too: ``_deblock_recon``, the in-loop
deblock of an SVC-coded picture through the deblock kernel,
``_planes_from_mbs``, and the per-picture ``_last_motion`` /
``_last_coeffs`` a following layer infers motion and residual from.  The
uncalled ``_encode_p`` is not ported.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from hartallo_tpu_torch.api import CodecConfig, EncodeResult
from hartallo_tpu_torch.bitio import BitWriter, insert_emulation_prevention
from hartallo_tpu_torch.decode import nal as N
from hartallo_tpu_torch.decode.params import PPS, SPS
from hartallo_tpu_torch.decode.sliceheader import SliceHeader, \
    write_slice_header
from hartallo_tpu_torch.encode.slice_encode import FramePacker
from hartallo_tpu_torch.decode.intra_recon import (PAD, availability_masks,
                                                   availability_tl,
                                                   availability_tr)
from hartallo_tpu_torch.encode.e_device import (INTRA_FIELDS, P_FIELDS,
                                                deblock_recon_device,
                                                i_frame_fused, p_frame_fused,
                                                p_gop_fused, pack_src,
                                                unpack)


def _guess_level(width: int, height: int) -> int:
    """Level from frame size (same ladder as the reference,
    hl_codec_264_utils.c:15-58)."""
    table = [(128, 96, 10), (176, 144, 11), (320, 240, 12), (352, 288, 13),
             (352, 480, 21), (720, 480, 30), (1280, 720, 31),
             (2048, 1024, 40), (2048, 1080, 42), (2560, 1920, 50),
             (3840, 2160, 51)]
    for w, h, lvl in table:
        if w >= width and h >= height:
            return lvl
    return 51


def _annexb(nal_payload: bytes) -> bytes:
    return b"\x00\x00\x00\x01" + nal_payload


def _lambda(qp_val: int) -> np.float32:
    """The f32 mode-decision lambda, computed in numpy as the JAX
    package does."""
    return np.float32(np.sqrt(0.85 * 2.0 ** ((qp_val - 12) / 3.0)))


class Encoder:
    """Encoder whose device programs run on ``device`` (every tensor it
    makes lives there)."""

    # chunk sizes for the P path (greedy largest-first), as in the JAX
    # package, so both split a GOP the same way
    P_CHUNKS = (8, 4, 2, 1)

    def __init__(self, config: CodecConfig, *, device="cuda"):
        self.cfg = config
        self.device = torch.device(device)
        self.frame_idx = 0
        self.gop_left = 0
        self.idr_pic_id = 0
        self.frame_num = 0
        self.sps: Optional[SPS] = None
        self.pps: Optional[PPS] = None
        self._ref_planes = None      # deblocked recon (padded) for P frames
        self._last_motion = None     # (mv44, ref_idx, intra) of the last
        self._last_coeffs = None     # picture; (arrays, qp, mb_kind) of it
        self._headers = b""
        self._rc = None              # JVT-G012 controller when rc enabled
        self._poc_cnt = 0            # frames since IDR (POC/2 for types 0/1)
        self._flags = (None, None)   # (slice layout, its device edge flags)

    # ------------------------------------------------------------------
    def _setup(self, width: int, height: int) -> None:
        gw, gh = (width + 15) // 16, (height + 15) // 16
        sps = SPS(profile_idc=66, constraint_set_flags=0x40,
                  level_idc=_guess_level(width, height),
                  log2_max_frame_num_minus4=4,
                  pic_order_cnt_type=self.cfg.poc_type,
                  max_num_ref_frames=1,
                  pic_width_in_mbs_minus1=gw - 1,
                  pic_height_in_map_units_minus1=gh - 1)
        if sps.pic_order_cnt_type == 0:
            sps.log2_max_pic_order_cnt_lsb_minus4 = 4
        elif sps.pic_order_cnt_type == 1:
            # POC = 2 * frames-since-IDR via a 1-entry ref cycle of +2,
            # no per-slice deltas (8.2.1.2 expectedPicOrderCnt)
            sps.delta_pic_order_always_zero_flag = 1
            sps.offset_for_ref_frame = [2]
        if width % 16 or height % 16:
            sps.frame_cropping_flag = 1
            sps.frame_crop_right_offset = (gw * 16 - width) // 2
            sps.frame_crop_bottom_offset = (gh * 16 - height) // 2
        pps = PPS(deblocking_filter_control_present_flag=1,
                  pic_init_qp_minus26=max(-26, min(25,
                                                   self.cfg.qp - 26)))
        if self.cfg.num_slice_groups > 1:
            # FMO emit (hl_codec_264_fmo.c semantics): one slice per group
            groups = min(self.cfg.num_slice_groups, 8)
            t = self.cfg.slice_group_map_type
            pps.num_slice_groups_minus1 = groups - 1
            pps.slice_group_map_type = t
            if t == 0:
                pps.run_length_minus1 = [gw - 1] * groups
            elif t == 2:
                # foreground column-band rectangles; last group = leftover,
                # clamped so every declared group gets a non-empty band
                groups = min(groups, gw)
                xs = sorted(set(round(i * gw / groups)
                                for i in range(groups + 1)))
                groups = len(xs) - 1
                pps.num_slice_groups_minus1 = groups - 1
                pps.top_left = [xs[g] for g in range(groups - 1)]
                pps.bottom_right = [(gh - 1) * gw + xs[g + 1] - 1
                                    for g in range(groups - 1)]
            elif t in (3, 4, 5):
                # changing groups (8.2.2.4-.6): exactly 2 groups, a change
                # rate, and a per-picture slice_group_change_cycle
                pps.num_slice_groups_minus1 = 1
                pps.slice_group_change_direction_flag = 0
                pps.slice_group_change_rate_minus1 = gw - 1
            elif t == 6:
                pps.slice_group_id = [
                    ((i % gw) + (i // gw)) % groups for i in range(gw * gh)]
            elif t != 1:
                raise ValueError("FMO emit supports map types 0/1/2/3/4/5/6")
        self.sps, self.pps = sps, pps
        w = BitWriter()
        N.write_nal_header(w, 3, N.NAL_SPS)
        sps.write(w)
        sps_nal = insert_emulation_prevention(w.getvalue())
        w = BitWriter()
        N.write_nal_header(w, 3, N.NAL_PPS)
        pps.write(w)
        pps_nal = insert_emulation_prevention(w.getvalue())
        self._headers = _annexb(sps_nal) + _annexb(pps_nal)

    # ------------------------------------------------------------------
    def encode_frame(self, frame: np.ndarray, width: int,
                     height: int) -> EncodeResult:
        """frame: packed I420 uint8 array/bytes of size w*h*3/2."""
        return self.finish_frame(self.encode_frame_async(frame, width,
                                                         height))

    def encode_frames(self, frames, width: int, height: int):
        """GOP-batched encode: the I frame alone, then runs of P frames K
        at a time (``e_device.p_gop_fused``) with the recon carried on the
        device; every picture's device work is issued before the first
        host packing.  Returns a list of EncodeResults in order."""
        if self.cfg.rc_bitrate and self.cfg.rc_bitrate > 0:
            # rate control closes the loop through real packed bits:
            # serial, frame at a time
            return [self.encode_frame(f, width, height) for f in frames]
        frames = list(frames)
        pend = []
        i = 0
        while i < len(frames):
            if self.gop_left <= 0 or self._ref_planes is None:
                pend.append(self.encode_frame_async(frames[i], width,
                                                    height))
                i += 1
                continue
            n_p = min(self.gop_left, len(frames) - i)
            b = next(c for c in self.P_CHUNKS if c <= n_p)
            pend.extend(self._encode_p_chunk_async(frames[i:i + b],
                                                   width, height))
            i += b
        return [self.finish_frame(p) for p in pend]

    # ------------------------------------------------------------------
    def _deblock_idc(self) -> int:
        if not self.cfg.deblock:
            return 1
        return 0 if self.cfg.deblock_slice_edges else 2

    def _deblock_masks(self, slice_id: np.ndarray):
        """(fmb_v, fmb_h) for the in-loop recon filter, honoring idc=2
        slice-boundary gating (8.7.2)."""
        gh, gw = slice_id.shape
        fmb_v = np.zeros((gh, gw), bool)
        fmb_v[:, 1:] = True
        fmb_h = np.zeros((gh, gw), bool)
        fmb_h[1:, :] = True
        if self._deblock_idc() == 2:
            fmb_v[:, 1:] &= slice_id[:, 1:] == slice_id[:, :-1]
            fmb_h[1:, :] &= slice_id[1:, :] == slice_id[:-1, :]
        return fmb_v, fmb_h

    def _deblock_flags(self, slice_id: np.ndarray):
        """``_deblock_masks`` as bool tensors on the encoder's device,
        made once per slice layout: no picture uploads them again."""
        key = (slice_id.shape, slice_id.tobytes(), self._deblock_idc())
        if self._flags[0] != key:
            self._flags = (key, tuple(self._tensor(f) for f in
                                      self._deblock_masks(slice_id)))
        return self._flags[1]

    def _fmo_change_cycle(self) -> int:
        """Per-picture slice_group_change_cycle for FMO map types 3..5
        (7.4.3): mid-range, so both groups stay non-empty.  0 for other
        map types."""
        pps = self.pps
        if pps is None or pps.num_slice_groups_minus1 == 0 or \
                pps.slice_group_map_type not in (3, 4, 5):
            return 0
        n = self.sps.pic_width_in_mbs * self.sps.pic_height_in_mbs
        rate = pps.slice_group_change_rate_minus1 + 1
        return max(1, (-(-n // rate)) // 2)

    def _slice_layout(self, gw: int, gh: int):
        """(ranges, slice_id, avail_l, avail_t, avail_tr, avail_tl) for
        the frame's slices."""
        if self.cfg.num_slice_groups > 1:
            # FMO: one slice per group, MBs visited in NextMbAddress order
            from hartallo_tpu_torch.decode.fmo import mb_to_slice_group_map
            sg = mb_to_slice_group_map(
                self.sps, self.pps,
                slice_group_change_cycle=self._fmo_change_cycle())
            slice_id = sg.reshape(gh, gw).astype(np.int32)
            ranges = [np.nonzero(sg == g)[0].astype(np.int32)
                      for g in range(self.pps.num_slice_groups_minus1 + 1)]
            # emit slices in increasing first-MB order (no ASO): with
            # changing map types (3..5) group 0 may start mid-frame
            ranges = sorted((o for o in ranges if len(o)),
                            key=lambda o: int(o[0]))
        else:
            ranges = self._slice_ranges(gh)
            slice_id = np.zeros((gh, gw), np.int32)
            for sid, (r0, r1) in enumerate(ranges):
                slice_id[r0:r1, :] = sid
        no_inter = np.zeros((gh, gw), bool)
        avail_l, avail_t = availability_masks(slice_id, False, no_inter)
        return (ranges, slice_id, avail_l, avail_t,
                availability_tr(slice_id, False, no_inter),
                availability_tl(slice_id, False, no_inter))

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=self.device)

    # ------------------------------------------------------------------
    def _encode_p_chunk_async(self, chunk, width: int, height: int):
        """Issue K consecutive P frames (fixed QP) with the recon carried
        on the device; returns K pending records for finish_frame."""
        sps, pps = self.sps, self.pps
        gw, gh = sps.pic_width_in_mbs, sps.pic_height_in_mbs
        K = len(chunk)
        src_k = self._tensor(np.stack([pack_src(f, width, height, gw, gh)
                                       for f in chunk]))
        qp_val = self.cfg.qp
        qp = np.full((gh, gw), qp_val, np.int32)
        lam = _lambda(qp_val)
        (ranges, slice_id, avail_l, avail_t, avail_tr,
         avail_tl) = self._slice_layout(gw, gh)
        fmb_v, fmb_h = self._deblock_flags(slice_id)
        two_t = self.cfg.temporal_layers >= 2
        tids = [(int((self._poc_cnt + k) % 2) if two_t else 0)
                for k in range(K)]
        refY, refU, refV = self._ref_planes
        R = int(min(self.cfg.me_range, PAD - 8))
        packed_k, _, recY, recU, recV = p_gop_fused(
            src_k, refY, refU, refV,
            self._tensor(qp).expand(K, gh, gw),
            self._tensor(np.full((K,), lam, np.float32)),
            fmb_v, fmb_h, np.array([t == 0 for t in tids]),
            *(self._tensor(a) for a in (avail_l, avail_t, avail_tr,
                                        avail_tl)),
            gw=gw, gh=gh, rng=R, refine=self.cfg.me_range > 0,
            chroma_qp_off=pps.chroma_qp_index_offset,
            deblock=bool(self.cfg.deblock),
            intra_in_p=bool(self.cfg.intra_in_p))
        self._ref_planes = (recY, recU, recV)
        shared = {"dev": packed_k, "np": None}
        pends = []
        for k in range(K):
            self.gop_left -= 1
            frame_num = self.frame_num
            poc_lsb = (2 * self._poc_cnt) % 256
            self._poc_cnt += 1
            if tids[k] == 0:
                self.frame_num = (self.frame_num + 1) % sps.max_frame_num
            self.frame_idx += 1
            pends.append({"packed_shared": (shared, k), "mad": 0,
                          "is_idr": False, "qp": qp, "qp_val": qp_val,
                          "ranges": ranges, "slice_id": slice_id,
                          "gw": gw, "gh": gh, "width": width,
                          "height": height, "tid": tids[k],
                          "frame_num": frame_num,
                          "idr_pic_id": self.idr_pic_id,
                          "poc_lsb": poc_lsb})
        return pends

    # ------------------------------------------------------------------
    def encode_frame_async(self, frame, width: int, height: int):
        """Issue the device half of one frame encode; the recon chain stays
        on the device so the next frame can be issued at once.  Returns a
        pending record for finish_frame."""
        if self.sps is None:
            self._setup(width, height)
        sps, pps = self.sps, self.pps
        gw, gh = sps.pic_width_in_mbs, sps.pic_height_in_mbs
        src_u8 = self._tensor(pack_src(frame, width, height, gw, gh))

        is_idr = self.gop_left <= 0 or self._ref_planes is None
        if is_idr:
            self.gop_left = max(self.cfg.gop_size, 1)
            self.frame_num = 0
        self.gop_left -= 1
        # hierarchical-P temporal scalability: odd frames since the IDR
        # are temporal_id 1 and non-reference (droppable); they predict
        # from the last T0 recon, which stays in _ref_planes
        tid = 0 if (is_idr or self.cfg.temporal_layers < 2) \
            else int(self._poc_cnt % 2)

        # rate control (JVT-G012 frame-level) or fixed QP
        if self.cfg.rc_bitrate and self.cfg.rc_bitrate > 0:
            if self._rc is None:
                from hartallo_tpu_torch.encode.ratecontrol import RateControl
                fnum, fden = self.cfg.fps
                self._rc = RateControl(
                    bitrate=float(self.cfg.rc_bitrate),
                    fps=float(fden) / float(fnum),
                    width=width, height=height,
                    gop_size=max(self.cfg.gop_size, 1),
                    qp_min=self.cfg.rc_qp_min, qp_max=self.cfg.rc_qp_max,
                    bits_min=float(self.cfg.rc_bitrate_min),
                    bits_max=float(self.cfg.rc_bitrate_max))
            if is_idr:
                self._rc.start_gop()
            qp_val = self._rc.frame_qp(is_idr)
        else:
            qp_val = self.cfg.qp

        qp = np.full((gh, gw), qp_val, np.int32)
        if self._rc is not None and self.cfg.rc_basic_unit and \
                not is_idr and self._ref_planes is not None:
            # basic-unit (MB-row) QP adaptation: per-row activity of the
            # incoming frame vs the reference recon
            buf = np.frombuffer(bytes(frame), np.uint8) if not \
                isinstance(frame, np.ndarray) else \
                np.asarray(frame).ravel()
            y = buf[:width * height].reshape(height, width)
            ry = self._ref_planes[0][PAD:PAD + gh * 16,
                                     PAD:PAD + gw * 16].cpu().numpy()
            hh = min(height, gh * 16)
            diff = np.abs(y[:hh].astype(np.int32) -
                          ry[:hh, :width].astype(np.int32))
            pad_rows = gh * 16 - hh
            if pad_rows:
                diff = np.vstack([diff, np.zeros((pad_rows, width),
                                                 np.int32)])
            row_mads = diff.reshape(gh, 16, -1).mean(axis=(1, 2))
            qp = np.broadcast_to(
                self._rc.row_qps(qp_val, row_mads, is_idr)[:, None],
                (gh, gw)).copy()
        lam = _lambda(qp_val)
        ranges, slice_id, avail_l, avail_t, avail_tr, avail_tl = \
            self._slice_layout(gw, gh)
        fmb_v, fmb_h = self._deblock_flags(slice_id)
        avail = [self._tensor(a) for a in (avail_l, avail_t, avail_tr,
                                           avail_tl)]
        if is_idr:
            packed, mad, recY, recU, recV = i_frame_fused(
                src_u8, self._tensor(qp), lam, *avail, fmb_v, fmb_h,
                gw=gw, gh=gh, chroma_qp_off=pps.chroma_qp_index_offset,
                deblock=bool(self.cfg.deblock))
        else:
            refY, refU, refV = self._ref_planes
            R = int(min(self.cfg.me_range, PAD - 8))
            packed, mad, recY, recU, recV = p_frame_fused(
                src_u8, refY, refU, refV, self._tensor(qp), lam, fmb_v,
                fmb_h, *avail, gw=gw, gh=gh, rng=R,
                refine=self.cfg.me_range > 0,
                chroma_qp_off=pps.chroma_qp_index_offset,
                deblock=bool(self.cfg.deblock),
                intra_in_p=bool(self.cfg.intra_in_p))
        if tid == 0:
            self._ref_planes = (recY, recU, recV)
        frame_num = self.frame_num
        if is_idr:
            self._poc_cnt = 0
            self.idr_pic_id = (self.idr_pic_id + 1) % 16
        poc_lsb = (2 * self._poc_cnt) % 256
        self._poc_cnt += 1
        if tid == 0:        # frame_num advances per REFERENCE frame (7.4.3)
            self.frame_num = (self.frame_num + 1) % sps.max_frame_num
        self.frame_idx += 1
        return {"packed": packed, "mad": mad, "is_idr": is_idr,
                "qp": qp, "qp_val": qp_val, "ranges": ranges,
                "slice_id": slice_id, "gw": gw, "gh": gh,
                "width": width, "height": height, "tid": tid,
                "frame_num": frame_num, "idr_pic_id": self.idr_pic_id,
                "poc_lsb": poc_lsb}

    # ------------------------------------------------------------------
    def finish_frame(self, pend) -> EncodeResult:
        """Host half: fetch the packed per-MB buffer (one copy; one per
        chunk on the P path), then MVD/skip derivation and the CAVLC slice
        packer."""
        gw, gh = pend["gw"], pend["gh"]
        qp, ranges = pend["qp"], pend["ranges"]
        is_idr = pend["is_idr"]
        if "packed_shared" in pend:
            shared, row = pend["packed_shared"]
            if shared["np"] is None:
                shared["np"] = shared["dev"].cpu().numpy()
            buf = shared["np"][row].astype(np.int32)
        else:
            buf = pend["packed"].cpu().numpy().astype(np.int32)

        if is_idr:
            arrays = unpack(buf, INTRA_FIELDS, gh, gw)
            mb_kind = np.where(arrays["use_i16"] > 0, 1, 0).astype(np.int8)
            self._last_coeffs = (arrays, qp, mb_kind)
            self._last_motion = (np.zeros((gh, gw, 4, 4, 2), np.int32),
                                 np.zeros((gh, gw, 4), np.int8),
                                 np.ones((gh, gw), bool))
            payload = self._pack_slices(arrays, qp, mb_kind, ranges,
                                        is_idr=True, is_p=False,
                                        frame_num=pend["frame_num"],
                                        idr_pic_id=pend["idr_pic_id"],
                                        poc_lsb=pend["poc_lsb"],
                                        ref_idc=3)
        else:
            from hartallo_tpu_torch.decode.mv import compute_mvds_and_skip
            from hartallo_tpu_torch.decode.slice_decode import (
                MB_P16X16, MB_P16X8, MB_P8X16, MB_P8X8)
            arrays = unpack(buf, P_FIELDS, gh, gw)
            choice_np = arrays["choice"]
            mb_kind = np.select(
                [choice_np == 0, choice_np == 1, choice_np == 2],
                [MB_P16X16, MB_P16X8, MB_P8X16], MB_P8X8).astype(np.int8)
            # intra-in-P: MBs the device pipeline coded intra
            is_intra = arrays["is_intra"] != 0
            mb_kind = np.where(is_intra,
                               np.where(arrays["use_i16"] != 0, 1, 0),
                               mb_kind).astype(np.int8)
            self._last_coeffs = (arrays, qp, mb_kind)
            arrays.update({
                "ref_idx": np.zeros((gh, gw, 4), np.int8),
                "sub_types": np.zeros((gh, gw, 4), np.int8),
            })
            coded = (arrays["luma_ac"].any(axis=(-1, -2, -3)) |
                     arrays["chroma_dc"].any(axis=(-1, -2, -3)) |
                     arrays["chroma_ac"].any(axis=(-1, -2, -3, -4)))
            mvd, skip_ok = compute_mvds_and_skip(
                mb_kind, arrays["mv44"], arrays["ref_idx"],
                arrays["sub_types"], coded, pend["slice_id"])
            self._last_motion = (arrays["mv44"].astype(np.int32),
                                 arrays["ref_idx"].astype(np.int8),
                                 is_intra)
            skip_ok &= mb_kind == MB_P16X16
            payload = self._pack_slices(arrays, qp, mb_kind, ranges,
                                        is_idr=False, is_p=True, mvd=mvd,
                                        skip_ok=skip_ok,
                                        frame_num=pend["frame_num"],
                                        idr_pic_id=pend["idr_pic_id"],
                                        poc_lsb=pend["poc_lsb"],
                                        ref_idc=0 if pend.get("tid")
                                        else 2)

        headers = self._headers if is_idr else b""
        if self._rc is not None:
            mad = float(pend["mad"]) / (gh * gw * 256)
            bits = (len(payload) + len(headers)) * 8
            self._rc.end_frame(pend["qp_val"], bits, mad, is_idr)
        return EncodeResult(data=payload, headers=headers,
                            keyframe=is_idr,
                            temporal_id=pend.get("tid", 0) or 0)

    # ------------------------------------------------------------------
    def _slice_ranges(self, gh: int):
        """Split the MB rows into N contiguous row-aligned ranges (the
        reference's contiguous MB-range slices,
        hl_codec_264_encode.c:479-524)."""
        n = max(1, min(self.cfg.slices, gh))
        bounds = [round(i * gh / n) for i in range(n + 1)]
        return [(bounds[i], bounds[i + 1]) for i in range(n)
                if bounds[i + 1] > bounds[i]]

    def _pack_one_slice(self, sid: int, rng, arrays, qp, mb_kind, *,
                        is_idr: bool, is_p: bool, mvd=None, skip_ok=None,
                        frame_num=None, idr_pic_id=None, poc_lsb=0,
                        ref_idc=None) -> bytes:
        """Pack one independent slice NAL.  ``rng`` is either a contiguous
        MB-row range (r0, r1) or an int32 array of MB addresses in FMO
        NextMbAddress order."""
        sps, pps = self.sps, self.pps
        gw = sps.pic_width_in_mbs
        if isinstance(rng, tuple):
            first_mb = rng[0] * gw
            order = None
        else:
            order = rng
            first_mb = int(order[0])
        fy, fx = first_mb // gw, first_mb % gw
        if frame_num is None:
            frame_num = self.frame_num
        if idr_pic_id is None:
            idr_pic_id = self.idr_pic_id
        hdr = SliceHeader(
            first_mb_in_slice=first_mb,
            slice_type=7 if not is_p else 5,   # all-slices-same convention
            pic_parameter_set_id=pps.pic_parameter_set_id,
            frame_num=0 if is_idr else frame_num,
            idr_pic_id=idr_pic_id if is_idr else 0,
            pic_order_cnt_lsb=poc_lsb if sps.pic_order_cnt_type == 0 else 0,
            slice_qp_delta=int(qp[fy, fx]) - pps.pic_init_qp,
            disable_deblocking_filter_idc=self._deblock_idc(),
            slice_group_change_cycle=self._fmo_change_cycle())
        w = BitWriter()
        ntype = N.NAL_SLICE_IDR if is_idr else N.NAL_SLICE
        if ref_idc is None:
            ref_idc = 3 if is_idr else 2
        N.write_nal_header(w, ref_idc, ntype)
        write_slice_header(w, hdr, sps, pps, nal_ref_idc=ref_idc,
                           is_idr=is_idr)
        from hartallo_tpu_torch import native
        if native.available() and order is None:
            r0, r1 = rng
            hdr_bytes, hdr_bits = w.partial()
            rbsp = native.pack_slice_data(
                hdr_bytes, hdr_bits, gw, sps.pic_height_in_mbs,
                hdr.slice_qp(pps), is_p, 1, sid, arrays, qp, mb_kind,
                mvd=mvd, skip_ok=skip_ok, first_mb=r0 * gw,
                mb_count=(r1 - r0) * gw)
            return _annexb(insert_emulation_prevention(rbsp))
        packer = FramePacker(gw, sps.pic_height_in_mbs, arrays, qp, mb_kind)
        qp_state = [hdr.slice_qp(pps)]
        run = 0
        if order is None:
            r0, r1 = rng
            order = range(r0 * gw, r1 * gw)
        for addr in order:
            my, mx = addr // gw, addr % gw
            if not is_p:
                packer.write_i_mb(w, mx, my, qp_state, sid)
                continue
            if skip_ok is not None and skip_ok[my, mx]:
                packer.mark_skip(mx, my, sid)
                run += 1
                continue
            w.ue(run)
            run = 0
            if mb_kind[my, mx] <= 2:
                packer.write_i_mb(w, mx, my, qp_state, sid,
                                  slice_is_p=True)
            else:
                packer.write_p_mb(w, mx, my, qp_state, sid, mvd, num_ref=1)
        if is_p and run > 0:
            w.ue(run)
        w.write_rbsp_trailing_bits()
        return _annexb(insert_emulation_prevention(w.getvalue()))

    def _pack_slices(self, arrays, qp, mb_kind, ranges, *, is_idr: bool,
                     is_p: bool, mvd=None, skip_ok=None, frame_num=None,
                     idr_pic_id=None, poc_lsb=0, ref_idc=None) -> bytes:
        """All slices of the frame; packed in parallel host threads when
        cfg.threads > 1 (the native packer releases the GIL)."""
        def one(item):
            sid, rng = item
            return self._pack_one_slice(
                sid, rng, arrays, qp, mb_kind, is_idr=is_idr, is_p=is_p,
                mvd=mvd, skip_ok=skip_ok, frame_num=frame_num,
                idr_pic_id=idr_pic_id, poc_lsb=poc_lsb, ref_idc=ref_idc)

        if len(ranges) > 1 and self.cfg.threads > 1:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(
                    max_workers=min(self.cfg.threads, len(ranges))) as ex:
                parts = list(ex.map(one, enumerate(ranges)))
        else:
            parts = [one(item) for item in enumerate(ranges)]
        return b"".join(parts)

    # ------------------------------------------------------------------
    def _deblock_recon(self, arrays, qp, mb_kind, planes, gw, gh):
        """In-loop deblock of a picture the SVC encoder coded, through
        ``deblock_frame_fast`` (the CUDA kernel on a CUDA device): bS from
        the luma AC TotalCoeff (what the decoder reconstructs from CAVLC),
        ``mb_kind <= 2`` as intra, ``arrays["mv44"]`` when present, one
        reference; slice offsets 0.  arrays/qp/mb_kind numpy, planes
        PAD-padded int32 tensors."""
        zeros44 = np.zeros((gh, gw, 4, 4), np.int32)
        mv44 = arrays.get("mv44", np.zeros((gh, gw, 4, 4, 2), np.int32))
        return deblock_recon_device(
            self._tensor(arrays["luma_ac"], torch.int32),
            self._tensor(mv44, torch.int32),
            self._tensor(zeros44), self._tensor(mb_kind <= 2),
            self._tensor(qp, torch.int32), self.pps.chroma_qp_index_offset,
            planes, gw, gh)


def _planes_from_mbs(mbs: torch.Tensor) -> torch.Tensor:
    """(gh, gw, S, S) MB tiles -> (gh*S, gw*S) plane."""
    gh, gw, S, _ = mbs.shape
    return mbs.permute(0, 2, 1, 3).reshape(gh * S, gw * S)
