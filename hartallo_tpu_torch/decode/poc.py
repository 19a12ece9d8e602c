"""Picture order count decoding, spec 8.2.1, POC types 0/1/2.

Reference parity: ``hl_codec_264_pict.c:45-222`` (hl_codec_264_poc_decode
with the three type branches).  Progressive frames only (the reference is
progressive-only too: ``hl_codec_264_encode.c:185-187``), so
TopFieldOrderCnt == BottomFieldOrderCnt == PicOrderCnt.
"""
from __future__ import annotations


class PocDecoder:
    """Per-layer POC state machine (one per DQId, like the reference's
    per-layer POC context in ``hl_codec_264_layer.h``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        # type 0 state
        self.prev_poc_msb = 0
        self.prev_poc_lsb = 0
        # types 1/2 state
        self.prev_frame_num = 0
        self.prev_frame_num_offset = 0

    def compute(self, sps, sh, nal_ref_idc: int, is_idr: bool,
                mmco5: bool = False) -> int:
        """POC of the current frame; updates the tracking state.

        sh: parsed SliceHeader (frame_num, pic_order_cnt_lsb,
        delta_pic_order_cnt).  mmco5: memory_management_control_operation
        5 seen in this picture's marking (resets expectations, 8.2.1).
        """
        t = sps.pic_order_cnt_type
        if t == 0:
            return self._type0(sps, sh, nal_ref_idc, is_idr, mmco5)
        if t == 1:
            return self._type1(sps, sh, nal_ref_idc, is_idr, mmco5)
        return self._type2(sps, sh, nal_ref_idc, is_idr, mmco5)

    # -- 8.2.1.1 -----------------------------------------------------------
    def _type0(self, sps, sh, nal_ref_idc, is_idr, mmco5):
        max_lsb = sps.max_pic_order_cnt_lsb
        if is_idr:
            prev_msb, prev_lsb = 0, 0
        else:
            prev_msb, prev_lsb = self.prev_poc_msb, self.prev_poc_lsb
        lsb = sh.pic_order_cnt_lsb
        if lsb < prev_lsb and (prev_lsb - lsb) >= max_lsb // 2:
            msb = prev_msb + max_lsb
        elif lsb > prev_lsb and (lsb - prev_lsb) > max_lsb // 2:
            msb = prev_msb - max_lsb
        else:
            msb = prev_msb
        poc = msb + lsb
        if nal_ref_idc:
            if mmco5:
                self.prev_poc_msb, self.prev_poc_lsb = 0, poc
            else:
                self.prev_poc_msb, self.prev_poc_lsb = msb, lsb
        return poc

    # -- 8.2.1.2 -----------------------------------------------------------
    def _type1(self, sps, sh, nal_ref_idc, is_idr, mmco5):
        max_fn = sps.max_frame_num
        n_cycle = len(sps.offset_for_ref_frame)
        if is_idr:
            frame_num_offset = 0
        elif self.prev_frame_num > sh.frame_num:
            frame_num_offset = self.prev_frame_num_offset + max_fn
        else:
            frame_num_offset = self.prev_frame_num_offset
        abs_frame_num = frame_num_offset + sh.frame_num \
            if n_cycle else 0
        if nal_ref_idc == 0 and abs_frame_num > 0:
            abs_frame_num -= 1
        expected = 0
        if abs_frame_num > 0:
            cycle = (abs_frame_num - 1) // n_cycle
            in_cycle = (abs_frame_num - 1) % n_cycle
            per_cycle = sum(sps.offset_for_ref_frame)
            expected = cycle * per_cycle + \
                sum(sps.offset_for_ref_frame[:in_cycle + 1])
        if nal_ref_idc == 0:
            expected += sps.offset_for_non_ref_pic
        poc = expected + sh.delta_pic_order_cnt[0]
        self.prev_frame_num = sh.frame_num
        self.prev_frame_num_offset = 0 if mmco5 else frame_num_offset
        return poc

    # -- 8.2.1.3 -----------------------------------------------------------
    def _type2(self, sps, sh, nal_ref_idc, is_idr, mmco5):
        max_fn = sps.max_frame_num
        if is_idr:
            frame_num_offset = 0
        elif self.prev_frame_num > sh.frame_num:
            frame_num_offset = self.prev_frame_num_offset + max_fn
        else:
            frame_num_offset = self.prev_frame_num_offset
        if is_idr:
            poc = 0
        elif nal_ref_idc == 0:
            poc = 2 * (frame_num_offset + sh.frame_num) - 1
        else:
            poc = 2 * (frame_num_offset + sh.frame_num)
        self.prev_frame_num = sh.frame_num
        self.prev_frame_num_offset = 0 if mmco5 else frame_num_offset
        return poc
