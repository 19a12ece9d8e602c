"""Sequence / picture parameter sets: parse and write (spec 7.3.2.1/7.3.2.2).

Reference parity: ``hl_codec_264_sps.c`` (994 LoC, incl. High-profile scaling
lists and SVC subset-SPS hooks), ``hl_codec_264_pps.c`` (484 LoC, FMO syntax),
``hl_codec_264_vui.c``.  Re-expressed as dataclasses + pure functions over
:class:`~hartallo_tpu.bitio.BitReader` / ``BitWriter``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from portbench.reference.h264.bitio import BitReader, BitWriter

PROFILE_BASELINE = 66
PROFILE_MAIN = 77
PROFILE_EXTENDED = 88
PROFILE_HIGH = 100
PROFILE_SCALABLE_BASELINE = 83
PROFILE_SCALABLE_HIGH = 86

_HIGH_PROFILES = (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135)


# ---------------------------------------------------------------------------
# Scaling lists (spec 7.3.2.1.1.1)
# ---------------------------------------------------------------------------

# Table 7-3 default scaling lists (zigzag scan order)
DEFAULT_4X4_INTRA = np.array(
    [6, 13, 13, 20, 20, 20, 28, 28, 28, 28, 32, 32, 32, 37, 37, 42],
    np.int32)
DEFAULT_4X4_INTER = np.array(
    [10, 14, 14, 20, 20, 20, 24, 24, 24, 24, 27, 27, 27, 30, 30, 34],
    np.int32)
_FLAT16 = np.full(16, 16, np.int32)


def _resolve_4x4(lists, base):
    """Table 7-2 fall-back: entry None=absent, "default", or ndarray(16).

    ``base``: the 6 lists to fall back to for indices 0 and 3 (the
    SPS-resolved lists under fall-back rule B, or defaults/flat under
    rule A).  NOTE: this implements the spec; the reference decoder
    errors out on absent lists (hl_codec_264_sps.c:252-257).
    """
    out = []
    for i in range(6):
        e = lists[i] if lists is not None and i < len(lists) else None
        if isinstance(e, np.ndarray):
            out.append(e.astype(np.int32))
        elif e == "default":
            out.append(DEFAULT_4X4_INTRA if i < 3 else DEFAULT_4X4_INTER)
        elif i == 0:
            out.append(base[0])
        elif i == 3:
            out.append(base[3])
        else:
            out.append(out[i - 1])
    return out


def effective_weight4x4(sps, pps):
    """(2, 3, 4, 4) weightScale per (mbIsInterFlag, iYCbCr), or None when
    every list is flat (8.5.9 derivation; zigzag inverse scan 8.5.6).
    Reference: _hl_codec_264_nal_pps_derive (hl_codec_264_pps.c:28-86)."""
    from portbench.reference.h264.core.tables import ZIGZAG_4x4
    seq_raw = getattr(sps, "scaling_lists_4x4", None)
    pic_raw = getattr(pps, "pic_scaling_lists_4x4", None)
    if seq_raw is None and pic_raw is None:
        return None
    defaults = [DEFAULT_4X4_INTRA] * 3 + [DEFAULT_4X4_INTER] * 3
    flats = [_FLAT16] * 6
    seq = _resolve_4x4(seq_raw, defaults if seq_raw is not None else flats)         if seq_raw is not None else flats
    if pic_raw is not None:
        lists = _resolve_4x4(pic_raw, seq if seq_raw is not None
                             else defaults)
    else:
        lists = seq
    if all((l == 16).all() for l in lists):
        return None
    w = np.zeros((2, 3, 4, 4), np.int32)
    zz = ZIGZAG_4x4.astype(int)
    for inter in range(2):
        for c in range(3):
            lst = lists[c + 3 * inter]
            flat = np.zeros(16, np.int32)
            flat[zz] = lst                 # inverse zigzag scan
            w[inter, c] = flat.reshape(4, 4)
    return w


def _parse_scaling_list(r: BitReader, size: int):
    """Returns (list or None-if-use-default, use_default_flag)."""
    scaling = np.zeros(size, dtype=np.int32)
    last_scale, next_scale = 8, 8
    use_default = False
    for j in range(size):
        if next_scale != 0:
            delta = r.se()
            next_scale = (last_scale + delta + 256) % 256
            if j == 0 and next_scale == 0:
                use_default = True
        scaling[j] = last_scale if next_scale == 0 else next_scale
        last_scale = int(scaling[j])
    return scaling, use_default


# ---------------------------------------------------------------------------
# HRD / VUI (spec E.1.1 / E.1.2) — parsed for completeness, mostly carried
# through; the reference parses these as passthrough too (hl_codec_264_vui.c).
# ---------------------------------------------------------------------------

@dataclass
class HRD:
    cpb_cnt_minus1: int = 0
    bit_rate_scale: int = 0
    cpb_size_scale: int = 0
    bit_rate_value_minus1: List[int] = field(default_factory=list)
    cpb_size_value_minus1: List[int] = field(default_factory=list)
    cbr_flag: List[int] = field(default_factory=list)
    initial_cpb_removal_delay_length_minus1: int = 23
    cpb_removal_delay_length_minus1: int = 23
    dpb_output_delay_length_minus1: int = 23
    time_offset_length: int = 24

    @classmethod
    def parse(cls, r: BitReader) -> "HRD":
        h = cls()
        h.cpb_cnt_minus1 = r.ue()
        h.bit_rate_scale = r.u(4)
        h.cpb_size_scale = r.u(4)
        for _ in range(h.cpb_cnt_minus1 + 1):
            h.bit_rate_value_minus1.append(r.ue())
            h.cpb_size_value_minus1.append(r.ue())
            h.cbr_flag.append(r.u1())
        h.initial_cpb_removal_delay_length_minus1 = r.u(5)
        h.cpb_removal_delay_length_minus1 = r.u(5)
        h.dpb_output_delay_length_minus1 = r.u(5)
        h.time_offset_length = r.u(5)
        return h


@dataclass
class VUI:
    aspect_ratio_info_present_flag: int = 0
    aspect_ratio_idc: int = 0
    sar_width: int = 0
    sar_height: int = 0
    overscan_info_present_flag: int = 0
    overscan_appropriate_flag: int = 0
    video_signal_type_present_flag: int = 0
    video_format: int = 5
    video_full_range_flag: int = 0
    colour_description_present_flag: int = 0
    colour_primaries: int = 2
    transfer_characteristics: int = 2
    matrix_coefficients: int = 2
    chroma_loc_info_present_flag: int = 0
    chroma_sample_loc_type_top_field: int = 0
    chroma_sample_loc_type_bottom_field: int = 0
    timing_info_present_flag: int = 0
    num_units_in_tick: int = 0
    time_scale: int = 0
    fixed_frame_rate_flag: int = 0
    nal_hrd: Optional[HRD] = None
    vcl_hrd: Optional[HRD] = None
    low_delay_hrd_flag: int = 0
    pic_struct_present_flag: int = 0
    bitstream_restriction_flag: int = 0
    motion_vectors_over_pic_boundaries_flag: int = 1
    max_bytes_per_pic_denom: int = 2
    max_bits_per_mb_denom: int = 1
    log2_max_mv_length_horizontal: int = 16
    log2_max_mv_length_vertical: int = 16
    max_num_reorder_frames: int = 0
    max_dec_frame_buffering: int = 0

    @classmethod
    def parse(cls, r: BitReader) -> "VUI":
        v = cls()
        v.aspect_ratio_info_present_flag = r.u1()
        if v.aspect_ratio_info_present_flag:
            v.aspect_ratio_idc = r.u(8)
            if v.aspect_ratio_idc == 255:  # Extended_SAR
                v.sar_width = r.u(16)
                v.sar_height = r.u(16)
        v.overscan_info_present_flag = r.u1()
        if v.overscan_info_present_flag:
            v.overscan_appropriate_flag = r.u1()
        v.video_signal_type_present_flag = r.u1()
        if v.video_signal_type_present_flag:
            v.video_format = r.u(3)
            v.video_full_range_flag = r.u1()
            v.colour_description_present_flag = r.u1()
            if v.colour_description_present_flag:
                v.colour_primaries = r.u(8)
                v.transfer_characteristics = r.u(8)
                v.matrix_coefficients = r.u(8)
        v.chroma_loc_info_present_flag = r.u1()
        if v.chroma_loc_info_present_flag:
            v.chroma_sample_loc_type_top_field = r.ue()
            v.chroma_sample_loc_type_bottom_field = r.ue()
        v.timing_info_present_flag = r.u1()
        if v.timing_info_present_flag:
            v.num_units_in_tick = r.u(32)
            v.time_scale = r.u(32)
            v.fixed_frame_rate_flag = r.u1()
        nal_hrd_present = r.u1()
        if nal_hrd_present:
            v.nal_hrd = HRD.parse(r)
        vcl_hrd_present = r.u1()
        if vcl_hrd_present:
            v.vcl_hrd = HRD.parse(r)
        if nal_hrd_present or vcl_hrd_present:
            v.low_delay_hrd_flag = r.u1()
        v.pic_struct_present_flag = r.u1()
        v.bitstream_restriction_flag = r.u1()
        if v.bitstream_restriction_flag:
            v.motion_vectors_over_pic_boundaries_flag = r.u1()
            v.max_bytes_per_pic_denom = r.ue()
            v.max_bits_per_mb_denom = r.ue()
            v.log2_max_mv_length_horizontal = r.ue()
            v.log2_max_mv_length_vertical = r.ue()
            v.max_num_reorder_frames = r.ue()
            v.max_dec_frame_buffering = r.ue()
        return v


# ---------------------------------------------------------------------------
# SPS
# ---------------------------------------------------------------------------

@dataclass
class SpsSvcExt:
    """seq_parameter_set_svc_extension (spec G.7.3.2.1.4); reference
    parse at hl_codec_264_sps.c:387+."""
    inter_layer_deblocking_filter_control_present_flag: int = 0
    extended_spatial_scalability_idc: int = 0
    chroma_phase_x_plus1_flag: int = 0
    chroma_phase_y_plus1: int = 0
    seq_ref_layer_chroma_phase_x_plus1_flag: int = 0
    seq_ref_layer_chroma_phase_y_plus1: int = 0
    seq_scaled_ref_layer_left_offset: int = 0
    seq_scaled_ref_layer_top_offset: int = 0
    seq_scaled_ref_layer_right_offset: int = 0
    seq_scaled_ref_layer_bottom_offset: int = 0
    seq_tcoeff_level_prediction_flag: int = 0
    adaptive_tcoeff_level_prediction_flag: int = 0
    slice_header_restriction_flag: int = 0

    @classmethod
    def parse(cls, r: BitReader, chroma_array_type: int = 1) -> "SpsSvcExt":
        e = cls()
        e.inter_layer_deblocking_filter_control_present_flag = r.u1()
        e.extended_spatial_scalability_idc = r.u(2)
        if chroma_array_type in (1, 2):
            e.chroma_phase_x_plus1_flag = r.u1()
        if chroma_array_type == 1:
            e.chroma_phase_y_plus1 = r.u(2)
        if e.extended_spatial_scalability_idc == 1:
            if chroma_array_type > 0:
                e.seq_ref_layer_chroma_phase_x_plus1_flag = r.u1()
                e.seq_ref_layer_chroma_phase_y_plus1 = r.u(2)
            e.seq_scaled_ref_layer_left_offset = r.se()
            e.seq_scaled_ref_layer_top_offset = r.se()
            e.seq_scaled_ref_layer_right_offset = r.se()
            e.seq_scaled_ref_layer_bottom_offset = r.se()
        e.seq_tcoeff_level_prediction_flag = r.u1()
        if e.seq_tcoeff_level_prediction_flag:
            e.adaptive_tcoeff_level_prediction_flag = r.u1()
        e.slice_header_restriction_flag = r.u1()
        return e

    def write(self, w: BitWriter, chroma_array_type: int = 1) -> None:
        w.u1(self.inter_layer_deblocking_filter_control_present_flag)
        w.u(self.extended_spatial_scalability_idc, 2)
        if chroma_array_type in (1, 2):
            w.u1(self.chroma_phase_x_plus1_flag)
        if chroma_array_type == 1:
            w.u(self.chroma_phase_y_plus1, 2)
        if self.extended_spatial_scalability_idc == 1:
            if chroma_array_type > 0:
                w.u1(self.seq_ref_layer_chroma_phase_x_plus1_flag)
                w.u(self.seq_ref_layer_chroma_phase_y_plus1, 2)
            w.se(self.seq_scaled_ref_layer_left_offset)
            w.se(self.seq_scaled_ref_layer_top_offset)
            w.se(self.seq_scaled_ref_layer_right_offset)
            w.se(self.seq_scaled_ref_layer_bottom_offset)
        w.u1(self.seq_tcoeff_level_prediction_flag)
        if self.seq_tcoeff_level_prediction_flag:
            w.u1(self.adaptive_tcoeff_level_prediction_flag)
        w.u1(self.slice_header_restriction_flag)


@dataclass
class SPS:
    profile_idc: int = PROFILE_BASELINE
    constraint_set_flags: int = 0          # 8 bits: set0..set5 + 2 reserved
    level_idc: int = 30
    seq_parameter_set_id: int = 0
    chroma_format_idc: int = 1
    separate_colour_plane_flag: int = 0
    bit_depth_luma_minus8: int = 0
    bit_depth_chroma_minus8: int = 0
    qpprime_y_zero_transform_bypass_flag: int = 0
    seq_scaling_matrix_present_flag: int = 0
    scaling_lists_4x4: Optional[list] = None   # 6 x ndarray(16) or None
    scaling_lists_8x8: Optional[list] = None   # 2+ x ndarray(64) or None
    log2_max_frame_num_minus4: int = 0
    pic_order_cnt_type: int = 0
    log2_max_pic_order_cnt_lsb_minus4: int = 0
    delta_pic_order_always_zero_flag: int = 0
    offset_for_non_ref_pic: int = 0
    offset_for_top_to_bottom_field: int = 0
    offset_for_ref_frame: List[int] = field(default_factory=list)
    max_num_ref_frames: int = 1
    gaps_in_frame_num_value_allowed_flag: int = 0
    pic_width_in_mbs_minus1: int = 0
    pic_height_in_map_units_minus1: int = 0
    frame_mbs_only_flag: int = 1
    mb_adaptive_frame_field_flag: int = 0
    direct_8x8_inference_flag: int = 1
    frame_cropping_flag: int = 0
    frame_crop_left_offset: int = 0
    frame_crop_right_offset: int = 0
    frame_crop_top_offset: int = 0
    frame_crop_bottom_offset: int = 0
    vui_parameters_present_flag: int = 0
    vui: Optional[VUI] = None
    svc: Optional["SpsSvcExt"] = None       # present on subset SPS

    # ---- derived (spec 7-9..7-17) ----
    @property
    def pic_width_in_mbs(self) -> int:
        return self.pic_width_in_mbs_minus1 + 1

    @property
    def pic_height_in_mbs(self) -> int:
        # frame_mbs_only assumed (reference is progressive-only too)
        return (self.pic_height_in_map_units_minus1 + 1) * \
            (2 - self.frame_mbs_only_flag)

    @property
    def width(self) -> int:
        return self.pic_width_in_mbs * 16

    @property
    def height(self) -> int:
        return self.pic_height_in_mbs * 16

    @property
    def max_frame_num(self) -> int:
        return 1 << (self.log2_max_frame_num_minus4 + 4)

    @property
    def max_pic_order_cnt_lsb(self) -> int:
        return 1 << (self.log2_max_pic_order_cnt_lsb_minus4 + 4)

    @classmethod
    def parse(cls, r: BitReader) -> "SPS":
        s = cls()
        s.profile_idc = r.u(8)
        s.constraint_set_flags = r.u(8)
        s.level_idc = r.u(8)
        s.seq_parameter_set_id = r.ue()
        if s.profile_idc in _HIGH_PROFILES:
            s.chroma_format_idc = r.ue()
            if s.chroma_format_idc == 3:
                s.separate_colour_plane_flag = r.u1()
            s.bit_depth_luma_minus8 = r.ue()
            s.bit_depth_chroma_minus8 = r.ue()
            s.qpprime_y_zero_transform_bypass_flag = r.u1()
            s.seq_scaling_matrix_present_flag = r.u1()
            if s.seq_scaling_matrix_present_flag:
                s.scaling_lists_4x4 = []
                s.scaling_lists_8x8 = []
                n8 = 2 if s.chroma_format_idc != 3 else 6
                for i in range(6 + n8):
                    present = r.u1()
                    if not present:
                        (s.scaling_lists_4x4 if i < 6
                         else s.scaling_lists_8x8).append(None)
                        continue
                    size = 16 if i < 6 else 64
                    lst, use_default = _parse_scaling_list(r, size)
                    (s.scaling_lists_4x4 if i < 6
                     else s.scaling_lists_8x8).append(
                        "default" if use_default else lst)
        s.log2_max_frame_num_minus4 = r.ue()
        s.pic_order_cnt_type = r.ue()
        if s.pic_order_cnt_type == 0:
            s.log2_max_pic_order_cnt_lsb_minus4 = r.ue()
        elif s.pic_order_cnt_type == 1:
            s.delta_pic_order_always_zero_flag = r.u1()
            s.offset_for_non_ref_pic = r.se()
            s.offset_for_top_to_bottom_field = r.se()
            n = r.ue()
            s.offset_for_ref_frame = [r.se() for _ in range(n)]
        s.max_num_ref_frames = r.ue()
        s.gaps_in_frame_num_value_allowed_flag = r.u1()
        s.pic_width_in_mbs_minus1 = r.ue()
        s.pic_height_in_map_units_minus1 = r.ue()
        s.frame_mbs_only_flag = r.u1()
        if not s.frame_mbs_only_flag:
            s.mb_adaptive_frame_field_flag = r.u1()
        s.direct_8x8_inference_flag = r.u1()
        s.frame_cropping_flag = r.u1()
        if s.frame_cropping_flag:
            s.frame_crop_left_offset = r.ue()
            s.frame_crop_right_offset = r.ue()
            s.frame_crop_top_offset = r.ue()
            s.frame_crop_bottom_offset = r.ue()
        s.vui_parameters_present_flag = r.u1()
        if s.vui_parameters_present_flag:
            s.vui = VUI.parse(r)
        return s

    def write(self, w: BitWriter, trailing: bool = True) -> None:
        w.u(self.profile_idc, 8)
        w.u(self.constraint_set_flags, 8)
        w.u(self.level_idc, 8)
        w.ue(self.seq_parameter_set_id)
        if self.profile_idc in _HIGH_PROFILES:
            w.ue(self.chroma_format_idc)
            if self.chroma_format_idc == 3:
                w.u1(self.separate_colour_plane_flag)
            w.ue(self.bit_depth_luma_minus8)
            w.ue(self.bit_depth_chroma_minus8)
            w.u1(self.qpprime_y_zero_transform_bypass_flag)
            if self.scaling_lists_4x4 is None:
                w.u1(0)  # seq_scaling_matrix_present_flag (flat lists)
            else:
                w.u1(1)
                n8 = 2 if self.chroma_format_idc != 3 else 6
                for i in range(6 + n8):
                    if i < 6:
                        lst = self.scaling_lists_4x4[i]
                    else:
                        lst = (self.scaling_lists_8x8[i - 6]
                               if self.scaling_lists_8x8 else None)
                    if lst is None or isinstance(lst, str):
                        w.u1(0)
                    else:
                        w.u1(1)
                        last = 8
                        for v in lst:
                            w.se(int(v) - last)
                            last = int(v)
        w.ue(self.log2_max_frame_num_minus4)
        w.ue(self.pic_order_cnt_type)
        if self.pic_order_cnt_type == 0:
            w.ue(self.log2_max_pic_order_cnt_lsb_minus4)
        elif self.pic_order_cnt_type == 1:
            w.u1(self.delta_pic_order_always_zero_flag)
            w.se(self.offset_for_non_ref_pic)
            w.se(self.offset_for_top_to_bottom_field)
            w.ue(len(self.offset_for_ref_frame))
            for off in self.offset_for_ref_frame:
                w.se(off)
        w.ue(self.max_num_ref_frames)
        w.u1(self.gaps_in_frame_num_value_allowed_flag)
        w.ue(self.pic_width_in_mbs_minus1)
        w.ue(self.pic_height_in_map_units_minus1)
        w.u1(self.frame_mbs_only_flag)
        if not self.frame_mbs_only_flag:
            w.u1(self.mb_adaptive_frame_field_flag)
        w.u1(self.direct_8x8_inference_flag)
        w.u1(self.frame_cropping_flag)
        if self.frame_cropping_flag:
            w.ue(self.frame_crop_left_offset)
            w.ue(self.frame_crop_right_offset)
            w.ue(self.frame_crop_top_offset)
            w.ue(self.frame_crop_bottom_offset)
        w.u1(0)  # vui_parameters_present_flag (not emitted)
        if trailing:
            w.write_rbsp_trailing_bits()


# ---------------------------------------------------------------------------
# PPS
# ---------------------------------------------------------------------------

@dataclass
class PPS:
    pic_parameter_set_id: int = 0
    seq_parameter_set_id: int = 0
    entropy_coding_mode_flag: int = 0       # 0 = CAVLC, 1 = CABAC
    bottom_field_pic_order_in_frame_present_flag: int = 0
    num_slice_groups_minus1: int = 0
    slice_group_map_type: int = 0
    run_length_minus1: List[int] = field(default_factory=list)
    top_left: List[int] = field(default_factory=list)
    bottom_right: List[int] = field(default_factory=list)
    slice_group_change_direction_flag: int = 0
    slice_group_change_rate_minus1: int = 0
    slice_group_id: List[int] = field(default_factory=list)
    num_ref_idx_l0_default_active_minus1: int = 0
    num_ref_idx_l1_default_active_minus1: int = 0
    weighted_pred_flag: int = 0
    weighted_bipred_idc: int = 0
    pic_init_qp_minus26: int = 0
    pic_init_qs_minus26: int = 0
    chroma_qp_index_offset: int = 0
    deblocking_filter_control_present_flag: int = 0
    constrained_intra_pred_flag: int = 0
    redundant_pic_cnt_present_flag: int = 0
    # More-data extensions (High profile)
    transform_8x8_mode_flag: int = 0
    pic_scaling_matrix_present_flag: int = 0
    pic_scaling_lists_4x4: Optional[list] = None
    second_chroma_qp_index_offset: Optional[int] = None

    @property
    def pic_init_qp(self) -> int:
        return self.pic_init_qp_minus26 + 26

    @classmethod
    def parse(cls, r: BitReader, chroma_format_idc: int = 1) -> "PPS":
        p = cls()
        p.pic_parameter_set_id = r.ue()
        p.seq_parameter_set_id = r.ue()
        p.entropy_coding_mode_flag = r.u1()
        p.bottom_field_pic_order_in_frame_present_flag = r.u1()
        p.num_slice_groups_minus1 = r.ue()
        if p.num_slice_groups_minus1 > 0:
            p.slice_group_map_type = r.ue()
            if p.slice_group_map_type == 0:
                p.run_length_minus1 = [
                    r.ue() for _ in range(p.num_slice_groups_minus1 + 1)]
            elif p.slice_group_map_type == 2:
                for _ in range(p.num_slice_groups_minus1):
                    p.top_left.append(r.ue())
                    p.bottom_right.append(r.ue())
            elif p.slice_group_map_type in (3, 4, 5):
                p.slice_group_change_direction_flag = r.u1()
                p.slice_group_change_rate_minus1 = r.ue()
            elif p.slice_group_map_type == 6:
                n = r.ue() + 1
                bits = max(1, (p.num_slice_groups_minus1 + 1 - 1)
                           .bit_length())
                p.slice_group_id = [r.u(bits) for _ in range(n)]
        p.num_ref_idx_l0_default_active_minus1 = r.ue()
        p.num_ref_idx_l1_default_active_minus1 = r.ue()
        p.weighted_pred_flag = r.u1()
        p.weighted_bipred_idc = r.u(2)
        p.pic_init_qp_minus26 = r.se()
        p.pic_init_qs_minus26 = r.se()
        p.chroma_qp_index_offset = r.se()
        p.deblocking_filter_control_present_flag = r.u1()
        p.constrained_intra_pred_flag = r.u1()
        p.redundant_pic_cnt_present_flag = r.u1()
        if r.more_rbsp_data():
            p.transform_8x8_mode_flag = r.u1()
            p.pic_scaling_matrix_present_flag = r.u1()
            if p.pic_scaling_matrix_present_flag:
                n8 = 2 if chroma_format_idc != 3 else 6
                count = 6 + (n8 if p.transform_8x8_mode_flag else 0)
                p.pic_scaling_lists_4x4 = []
                for i in range(count):
                    if not r.u1():
                        if i < 6:
                            p.pic_scaling_lists_4x4.append(None)
                        continue
                    lst, use_default = _parse_scaling_list(
                        r, 16 if i < 6 else 64)
                    if i < 6:
                        p.pic_scaling_lists_4x4.append(
                            "default" if use_default else lst)
            p.second_chroma_qp_index_offset = r.se()
        return p

    def write(self, w: BitWriter) -> None:
        w.ue(self.pic_parameter_set_id)
        w.ue(self.seq_parameter_set_id)
        w.u1(self.entropy_coding_mode_flag)
        w.u1(self.bottom_field_pic_order_in_frame_present_flag)
        w.ue(self.num_slice_groups_minus1)
        if self.num_slice_groups_minus1 > 0:
            w.ue(self.slice_group_map_type)
            if self.slice_group_map_type == 0:
                for v in self.run_length_minus1:
                    w.ue(v)
            elif self.slice_group_map_type == 2:
                for tl, br in zip(self.top_left, self.bottom_right):
                    w.ue(tl)
                    w.ue(br)
            elif self.slice_group_map_type in (3, 4, 5):
                w.u1(self.slice_group_change_direction_flag)
                w.ue(self.slice_group_change_rate_minus1)
            elif self.slice_group_map_type == 6:
                w.ue(len(self.slice_group_id) - 1)
                bits = max(1, self.num_slice_groups_minus1.bit_length())
                for g in self.slice_group_id:
                    w.u(g, bits)
        w.ue(self.num_ref_idx_l0_default_active_minus1)
        w.ue(self.num_ref_idx_l1_default_active_minus1)
        w.u1(self.weighted_pred_flag)
        w.u(self.weighted_bipred_idc, 2)
        w.se(self.pic_init_qp_minus26)
        w.se(self.pic_init_qs_minus26)
        w.se(self.chroma_qp_index_offset)
        w.u1(self.deblocking_filter_control_present_flag)
        w.u1(self.constrained_intra_pred_flag)
        w.u1(self.redundant_pic_cnt_present_flag)
        w.write_rbsp_trailing_bits()


def parse_subset_sps(r: BitReader) -> SPS:
    """subset_seq_parameter_set_rbsp (spec 7.3.2.1.3): SPS data + SVC
    extension for Scalable profiles."""
    sps = SPS.parse(r)
    if sps.profile_idc in (PROFILE_SCALABLE_BASELINE, PROFILE_SCALABLE_HIGH):
        sps.svc = SpsSvcExt.parse(r, 1)
        r.u1()  # svc_vui_parameters_present_flag
    return sps


def write_subset_sps(w: BitWriter, sps: SPS) -> None:
    sps.write(w, trailing=False)
    if sps.svc is not None:
        sps.svc.write(w, 1)
        w.u1(0)  # svc_vui_parameters_present_flag
    w.u1(0)      # additional_extension2_flag
    w.write_rbsp_trailing_bits()
