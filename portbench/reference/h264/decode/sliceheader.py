"""Slice header parse/write (spec 7.3.3) + derived variables.

Reference parity: ``hl_codec_264_slice.c:53-160`` (derivations), ``:300-700``
(read), ``:760-1000`` (write); ref-pic-list modification and MMCO syntax from
``hl_codec_264_reflist.c`` / ``hl_codec_264_rbsp.c``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from portbench.reference.h264.bitio import BitReader, BitWriter
from portbench.reference.h264.decode.params import PPS, SPS

# slice_type values (spec Table 7-6); values 5..9 assert all slices in the
# picture share the type.
SLICE_P, SLICE_B, SLICE_I, SLICE_SP, SLICE_SI = range(5)


def slice_type_base(st: int) -> int:
    return st % 5


@dataclass
class RefPicListMod:
    """One ref_pic_list_modification operation."""
    idc: int                 # modification_of_pic_nums_idc (0,1,2)
    value: int               # abs_diff_pic_num_minus1 or long_term_pic_num


@dataclass
class MMCO:
    """One memory_management_control_operation."""
    op: int
    value1: int = 0
    value2: int = 0


@dataclass
class PredWeightTable:
    """Explicit weighted-prediction table (spec 7.3.3.2, L0 only — the
    codec scope is P slices).  Weights default to 1 << denom, offsets 0.
    Note: the reference PARSES this syntax (hl_codec_264_rbsp.c:289-358)
    but its decoder bails with NOT_IMPLEMENTED on weighted_pred_flag
    (hl_codec_264_pred_inter.c:118-124); we implement the full 8.4.2.3.2
    explicit weighted sample prediction."""
    luma_log2_denom: int = 0
    chroma_log2_denom: int = 0
    luma_w: List[int] = field(default_factory=list)     # per refIdx
    luma_o: List[int] = field(default_factory=list)
    chroma_w: List[Tuple[int, int]] = field(default_factory=list)
    chroma_o: List[Tuple[int, int]] = field(default_factory=list)


def _parse_pred_weight_table(r: BitReader, num_l0: int) -> PredWeightTable:
    t = PredWeightTable()
    t.luma_log2_denom = r.ue()
    t.chroma_log2_denom = r.ue()
    for _ in range(num_l0):
        lw, lo = 1 << t.luma_log2_denom, 0
        if r.u1():                      # luma_weight_l0_flag
            lw = r.se()
            lo = r.se()
        t.luma_w.append(lw)
        t.luma_o.append(lo)
        cw = [1 << t.chroma_log2_denom] * 2
        co = [0, 0]
        if r.u1():                      # chroma_weight_l0_flag
            for j in range(2):
                cw[j] = r.se()
                co[j] = r.se()
        t.chroma_w.append((cw[0], cw[1]))
        t.chroma_o.append((co[0], co[1]))
    return t


def write_pred_weight_table(w: BitWriter, t: PredWeightTable,
                            num_l0: int) -> None:
    w.ue(t.luma_log2_denom)
    w.ue(t.chroma_log2_denom)
    for i in range(num_l0):
        lw = t.luma_w[i] if i < len(t.luma_w) else 1 << t.luma_log2_denom
        lo = t.luma_o[i] if i < len(t.luma_o) else 0
        default_l = lw == (1 << t.luma_log2_denom) and lo == 0
        w.u1(0 if default_l else 1)
        if not default_l:
            w.se(lw)
            w.se(lo)
        cw = t.chroma_w[i] if i < len(t.chroma_w) else \
            (1 << t.chroma_log2_denom,) * 2
        co = t.chroma_o[i] if i < len(t.chroma_o) else (0, 0)
        default_c = all(cw[j] == (1 << t.chroma_log2_denom) and co[j] == 0
                        for j in range(2))
        w.u1(0 if default_c else 1)
        if not default_c:
            for j in range(2):
                w.se(cw[j])
                w.se(co[j])


@dataclass
class SliceHeader:
    first_mb_in_slice: int = 0
    slice_type: int = SLICE_I
    pic_parameter_set_id: int = 0
    frame_num: int = 0
    idr_pic_id: int = 0
    pic_order_cnt_lsb: int = 0
    delta_pic_order_cnt_bottom: int = 0
    delta_pic_order_cnt: Tuple[int, int] = (0, 0)
    redundant_pic_cnt: int = 0
    num_ref_idx_active_override_flag: int = 0
    num_ref_idx_l0_active_minus1: int = 0
    num_ref_idx_l1_active_minus1: int = 0
    ref_pic_list_mods_l0: Optional[List[RefPicListMod]] = None
    ref_pic_list_mods_l1: Optional[List[RefPicListMod]] = None
    no_output_of_prior_pics_flag: int = 0
    long_term_reference_flag: int = 0
    adaptive_ref_pic_marking_mode_flag: int = 0
    pred_weights: Optional[PredWeightTable] = None
    mmcos: List[MMCO] = field(default_factory=list)
    cabac_init_idc: int = 0
    slice_qp_delta: int = 0
    disable_deblocking_filter_idc: int = 0
    slice_alpha_c0_offset_div2: int = 0
    slice_beta_offset_div2: int = 0
    slice_group_change_cycle: int = 0
    # SVC slice-header-in-scalable-extension extras (spec G.7.3.3.4),
    # parsed when the NAL is type 20 and not a base-layer representation.
    ref_layer_dq_id: int = -1
    disable_inter_layer_deblocking_filter_idc: int = 0
    inter_layer_slice_alpha_c0_offset_div2: int = 0
    inter_layer_slice_beta_offset_div2: int = 0
    constrained_intra_resampling_flag: int = 0
    scaled_ref_layer_left_offset: int = 0
    scaled_ref_layer_top_offset: int = 0
    scaled_ref_layer_right_offset: int = 0
    scaled_ref_layer_bottom_offset: int = 0
    slice_skip_flag: int = 0
    num_mbs_in_slice_minus1: int = 0
    adaptive_base_mode_flag: int = 0
    default_base_mode_flag: int = 0
    adaptive_motion_prediction_flag: int = 0
    default_motion_prediction_flag: int = 0
    adaptive_residual_prediction_flag: int = 0
    default_residual_prediction_flag: int = 0
    tcoeff_level_prediction_flag: int = 0
    scan_idx_start: int = 0
    scan_idx_end: int = 15

    @property
    def type_base(self) -> int:
        return self.slice_type % 5

    @property
    def is_p(self) -> bool:
        return self.type_base == SLICE_P

    @property
    def is_i(self) -> bool:
        return self.type_base == SLICE_I

    def slice_qp(self, pps: PPS) -> int:
        return 26 + pps.pic_init_qp_minus26 + self.slice_qp_delta


def _parse_ref_pic_list_mods(r: BitReader) -> Optional[List[RefPicListMod]]:
    if not r.u1():  # ref_pic_list_modification_flag
        return None
    mods: List[RefPicListMod] = []
    while True:
        idc = r.ue()
        if idc == 3:
            break
        mods.append(RefPicListMod(idc=idc, value=r.ue()))
    return mods


def parse_slice_header(r: BitReader, sps: SPS, pps: PPS, *,
                       nal_ref_idc: int, is_idr: bool,
                       svc_ext: bool = False,
                       no_inter_layer_pred: bool = True,
                       quality_id: int = 0) -> SliceHeader:
    h = SliceHeader()
    h.first_mb_in_slice = r.ue()
    h.slice_type = r.ue()
    h.pic_parameter_set_id = r.ue()
    if sps.separate_colour_plane_flag:
        r.u(2)  # colour_plane_id
    h.frame_num = r.u(sps.log2_max_frame_num_minus4 + 4)
    if not sps.frame_mbs_only_flag:
        if r.u1():      # field_pic_flag
            r.u1()      # bottom_field_flag
    if is_idr:
        h.idr_pic_id = r.ue()
    if sps.pic_order_cnt_type == 0:
        h.pic_order_cnt_lsb = r.u(sps.log2_max_pic_order_cnt_lsb_minus4 + 4)
        if pps.bottom_field_pic_order_in_frame_present_flag:
            h.delta_pic_order_cnt_bottom = r.se()
    elif sps.pic_order_cnt_type == 1 and \
            not sps.delta_pic_order_always_zero_flag:
        d0 = r.se()
        d1 = r.se() if pps.bottom_field_pic_order_in_frame_present_flag else 0
        h.delta_pic_order_cnt = (d0, d1)
    if pps.redundant_pic_cnt_present_flag:
        h.redundant_pic_cnt = r.ue()
    base = h.type_base
    if not (svc_ext and quality_id > 0):
        if base == SLICE_B:
            r.u1()  # direct_spatial_mv_pred_flag
        if base in (SLICE_P, SLICE_SP, SLICE_B):
            h.num_ref_idx_l0_active_minus1 = \
                pps.num_ref_idx_l0_default_active_minus1
            h.num_ref_idx_active_override_flag = r.u1()
            if h.num_ref_idx_active_override_flag:
                h.num_ref_idx_l0_active_minus1 = r.ue()
                if base == SLICE_B:
                    h.num_ref_idx_l1_active_minus1 = r.ue()
        if base != SLICE_I and base != SLICE_SI:
            h.ref_pic_list_mods_l0 = _parse_ref_pic_list_mods(r)
            if base == SLICE_B:
                h.ref_pic_list_mods_l1 = _parse_ref_pic_list_mods(r)
        if (pps.weighted_pred_flag and base in (SLICE_P, SLICE_SP)) or \
                (pps.weighted_bipred_idc == 1 and base == SLICE_B):
            h.pred_weights = _parse_pred_weight_table(
                r, h.num_ref_idx_l0_active_minus1 + 1)
        if nal_ref_idc != 0:
            if is_idr:
                h.no_output_of_prior_pics_flag = r.u1()
                h.long_term_reference_flag = r.u1()
            else:
                h.adaptive_ref_pic_marking_mode_flag = r.u1()
                if h.adaptive_ref_pic_marking_mode_flag:
                    while True:
                        op = r.ue()
                        if op == 0:
                            break
                        m = MMCO(op=op)
                        if op in (1, 3):
                            m.value1 = r.ue()  # difference_of_pic_nums_minus1
                        if op == 2:
                            m.value1 = r.ue()  # long_term_pic_num
                        if op in (3, 6):
                            m.value2 = r.ue()  # long_term_frame_idx
                        if op == 4:
                            m.value1 = r.ue()  # max_long_term_frame_idx_plus1
                        h.mmcos.append(m)
    if pps.entropy_coding_mode_flag and base not in (SLICE_I, SLICE_SI):
        h.cabac_init_idc = r.ue()
    h.slice_qp_delta = r.se()
    if base in (SLICE_SP, SLICE_SI):
        if base == SLICE_SP:
            r.u1()  # sp_for_switch_flag
        r.se()      # slice_qs_delta
    if pps.deblocking_filter_control_present_flag:
        h.disable_deblocking_filter_idc = r.ue()
        if h.disable_deblocking_filter_idc != 1:
            h.slice_alpha_c0_offset_div2 = r.se()
            h.slice_beta_offset_div2 = r.se()
    if pps.num_slice_groups_minus1 > 0 and \
            pps.slice_group_map_type in (3, 4, 5):
        pic_size_in_map_units = (sps.pic_width_in_mbs_minus1 + 1) * \
            (sps.pic_height_in_map_units_minus1 + 1)
        rate = pps.slice_group_change_rate_minus1 + 1
        # Ceil(Log2(Ceil(PicSizeInMapUnits / SliceGroupChangeRate) + 1))
        # (spec 7.4.3; hl_codec_264_slice.c:548-552)
        bits = math.ceil(math.log2(-(-pic_size_in_map_units // rate) + 1))
        h.slice_group_change_cycle = r.u(bits)
    if svc_ext:
        svc_sps = sps.svc
        if not no_inter_layer_pred and quality_id == 0:
            h.ref_layer_dq_id = r.ue()
            if svc_sps is not None and \
                    svc_sps.inter_layer_deblocking_filter_control_present_flag:
                h.disable_inter_layer_deblocking_filter_idc = r.ue()
                if h.disable_inter_layer_deblocking_filter_idc != 1:
                    h.inter_layer_slice_alpha_c0_offset_div2 = r.se()
                    h.inter_layer_slice_beta_offset_div2 = r.se()
            h.constrained_intra_resampling_flag = r.u1()
            if svc_sps is not None and \
                    svc_sps.extended_spatial_scalability_idc == 2:
                r.u(3)  # ref_layer chroma phase flags (ChromaArrayType 1)
                h.scaled_ref_layer_left_offset = r.se()
                h.scaled_ref_layer_top_offset = r.se()
                h.scaled_ref_layer_right_offset = r.se()
                h.scaled_ref_layer_bottom_offset = r.se()
        if not no_inter_layer_pred:
            h.slice_skip_flag = r.u1()
            if h.slice_skip_flag:
                h.num_mbs_in_slice_minus1 = r.ue()
            else:
                h.adaptive_base_mode_flag = r.u1()
                if not h.adaptive_base_mode_flag:
                    h.default_base_mode_flag = r.u1()
                if not h.default_base_mode_flag:
                    h.adaptive_motion_prediction_flag = r.u1()
                    if not h.adaptive_motion_prediction_flag:
                        h.default_motion_prediction_flag = r.u1()
                h.adaptive_residual_prediction_flag = r.u1()
                if not h.adaptive_residual_prediction_flag:
                    h.default_residual_prediction_flag = r.u1()
            if svc_sps is not None and \
                    svc_sps.adaptive_tcoeff_level_prediction_flag:
                h.tcoeff_level_prediction_flag = r.u1()
        if svc_sps is not None and \
                not svc_sps.slice_header_restriction_flag and \
                not h.slice_skip_flag:
            h.scan_idx_start = r.u(4)
            h.scan_idx_end = r.u(4)
    return h


def write_slice_header(w: BitWriter, h: SliceHeader, sps: SPS, pps: PPS, *,
                       nal_ref_idc: int, is_idr: bool,
                       svc_ext: bool = False,
                       no_inter_layer_pred: bool = True,
                       quality_id: int = 0) -> None:
    w.ue(h.first_mb_in_slice)
    w.ue(h.slice_type)
    w.ue(h.pic_parameter_set_id)
    w.u(h.frame_num, sps.log2_max_frame_num_minus4 + 4)
    if is_idr:
        w.ue(h.idr_pic_id)
    if sps.pic_order_cnt_type == 0:
        w.u(h.pic_order_cnt_lsb, sps.log2_max_pic_order_cnt_lsb_minus4 + 4)
        if pps.bottom_field_pic_order_in_frame_present_flag:
            w.se(h.delta_pic_order_cnt_bottom)
    if pps.redundant_pic_cnt_present_flag:
        w.ue(h.redundant_pic_cnt)
    base = h.type_base
    if not (svc_ext and quality_id > 0):
        # G.7.3.4: slices with quality_id > 0 inherit these fields from
        # the quality-base slice of the access unit
        if base in (SLICE_P, SLICE_SP):
            w.u1(h.num_ref_idx_active_override_flag)
            if h.num_ref_idx_active_override_flag:
                w.ue(h.num_ref_idx_l0_active_minus1)
        if base not in (SLICE_I, SLICE_SI):
            if h.ref_pic_list_mods_l0:
                w.u1(1)
                for mod in h.ref_pic_list_mods_l0:
                    w.ue(mod.idc)
                    w.ue(mod.value)
                w.ue(3)                     # end of modifications
            else:
                w.u1(0)  # ref_pic_list_modification_flag_l0
        if pps.weighted_pred_flag and base in (SLICE_P, SLICE_SP):
            write_pred_weight_table(w, h.pred_weights or PredWeightTable(),
                                    h.num_ref_idx_l0_active_minus1 + 1)
        if nal_ref_idc != 0:
            if is_idr:
                w.u1(h.no_output_of_prior_pics_flag)
                w.u1(h.long_term_reference_flag)
            elif h.mmcos:
                w.u1(1)  # adaptive_ref_pic_marking_mode_flag
                for m in h.mmcos:
                    w.ue(m.op)
                    if m.op in (1, 3):
                        w.ue(m.value1)
                    if m.op == 2:
                        w.ue(m.value1)
                    if m.op in (3, 6):
                        w.ue(m.value2)
                    if m.op == 4:
                        w.ue(m.value1)
                w.ue(0)
            else:
                w.u1(0)  # adaptive_ref_pic_marking (sliding window)
    w.se(h.slice_qp_delta)
    if pps.deblocking_filter_control_present_flag:
        w.ue(h.disable_deblocking_filter_idc)
        if h.disable_deblocking_filter_idc != 1:
            w.se(h.slice_alpha_c0_offset_div2)
            w.se(h.slice_beta_offset_div2)
    if pps.num_slice_groups_minus1 > 0 and \
            pps.slice_group_map_type in (3, 4, 5):
        pic_size_in_map_units = (sps.pic_width_in_mbs_minus1 + 1) * \
            (sps.pic_height_in_map_units_minus1 + 1)
        rate = pps.slice_group_change_rate_minus1 + 1
        bits = math.ceil(math.log2(-(-pic_size_in_map_units // rate) + 1))
        w.u(h.slice_group_change_cycle, bits)
    if svc_ext:
        svc_sps = sps.svc
        if not no_inter_layer_pred and quality_id == 0:
            w.ue(h.ref_layer_dq_id)
            if svc_sps is not None and \
                    svc_sps.inter_layer_deblocking_filter_control_present_flag:
                w.ue(h.disable_inter_layer_deblocking_filter_idc)
                if h.disable_inter_layer_deblocking_filter_idc != 1:
                    w.se(h.inter_layer_slice_alpha_c0_offset_div2)
                    w.se(h.inter_layer_slice_beta_offset_div2)
            w.u1(h.constrained_intra_resampling_flag)
        if not no_inter_layer_pred:
            w.u1(0)  # slice_skip_flag
            w.u1(h.adaptive_base_mode_flag)
            if not h.adaptive_base_mode_flag:
                w.u1(h.default_base_mode_flag)
            if not h.default_base_mode_flag:
                w.u1(h.adaptive_motion_prediction_flag)
                if not h.adaptive_motion_prediction_flag:
                    w.u1(h.default_motion_prediction_flag)
            w.u1(h.adaptive_residual_prediction_flag)
            if not h.adaptive_residual_prediction_flag:
                w.u1(h.default_residual_prediction_flag)
        if svc_sps is not None and \
                not svc_sps.slice_header_restriction_flag:
            w.u(h.scan_idx_start, 4)
            w.u(h.scan_idx_end, 4)
