"""The plain reference decoder of the benchmark: one AVC picture at a time.

``decode_picture`` reconstructs one coded picture from its slice NAL
units and the picture it predicts from, with the frozen copy of the
port's plain paths (``h264``): the pure-Python slice parse and MV
derivation, the residual, inter and intra prediction twins and the
deblocking twin, every tensor on the CPU.  It follows the port's general
route (``Decoder._reconstruct_general``) for the streams the benchmark
makes: AVC, one reference picture, no weighted prediction, no SVC.

The decode cells call it for each picture of their sample and the one
before it: that one from the frame the program returned two pictures
back, the sampled one from the reference's own frame (an IDR picture
takes none).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference.h264.bitio import (BitReader, find_nal_units,
                                            strip_emulation_prevention)
from portbench.reference.h264.decode import inter_recon, nal as N
from portbench.reference.h264.decode.d_device import (decode_frame_pre,
                                                      edge_pad_device)
from portbench.reference.h264.decode.intra_recon import (
    PAD, availability_masks, availability_tr, intra_reconstruct)
from portbench.reference.h264.decode.mv import derive_mvs
from portbench.reference.h264.decode.params import PPS, SPS
from portbench.reference.h264.decode.slice_decode import (
    MB_I16, MB_I4X4, MB_IBL, MB_PCM, SliceData, SliceDecoder)
from portbench.reference.h264.decode.sliceheader import parse_slice_header
from portbench.reference.h264.ops.interpol import (_TAPS, _conv6_last,
                                                   _flat_ref, luma_mc_blocks)
from portbench.reference.h264.ops.deblock_fast import (
    RECORD_OFFSETS, deblock_frame_aux_plain, deblock_params_dec_plain,
    pack_deblock_record)

@dataclass
class Picture:
    """One coded picture of a stream: its slice NAL units (no start
    codes) and whether it is an IDR picture."""
    nals: list
    idr: bool


def split_stream(data: bytes):
    """(sps, pps, [Picture]) of an AVC Annex-B stream with one SPS and one
    PPS (the last of each wins) and one or more slices a picture."""
    sps = pps = None
    pictures = []
    last_frame_num = None
    for s, e in find_nal_units(data):
        nal = data[s:e]
        r = BitReader(strip_emulation_prevention(nal))
        hdr = N.parse_nal_header(r)
        if hdr.type == N.NAL_SPS:
            sps = SPS.parse(r)
        elif hdr.type == N.NAL_PPS:
            pps = PPS.parse(r)
        elif hdr.type in (N.NAL_SLICE, N.NAL_SLICE_IDR):
            first_mb = r.ue()
            r.ue()                                   # slice_type
            r.ue()                                   # pps id
            frame_num = r.u(sps.log2_max_frame_num_minus4 + 4)
            if first_mb == 0 or frame_num != last_frame_num:
                pictures.append(Picture([], hdr.type == N.NAL_SLICE_IDR))
            pictures[-1].nals.append(nal)
            last_frame_num = frame_num
    if sps is None or pps is None:
        raise ValueError("stream without SPS or PPS")
    return sps, pps, pictures


def _filter_flags(sd: SliceData):
    """(fmb_v, fmb_h, filter_internal) of disable_deblocking_filter_idc,
    as the port's ``Decoder._filter_flags``."""
    gw, gh = sd.gw, sd.gh
    idc = sd.deblock_idc.astype(np.int32)
    internal = idc != 1
    same_l = np.zeros((gh, gw), bool)
    same_t = np.zeros((gh, gw), bool)
    same_l[:, 1:] = sd.slice_id[:, 1:] == sd.slice_id[:, :-1]
    same_t[1:, :] = sd.slice_id[1:, :] == sd.slice_id[:-1, :]
    has_l = np.zeros((gh, gw), bool)
    has_l[:, 1:] = True
    has_t = np.zeros((gh, gw), bool)
    has_t[1:, :] = True
    return (internal & has_l & ((idc != 2) | same_l),
            internal & has_t & ((idc != 2) | same_t), internal)


def i420_planes(frame: np.ndarray, gw: int, gh: int):
    """The (Y, U, V) planes of a packed I420 frame of gw x gh MBs."""
    H, W = gh * 16, gw * 16
    y = frame[:H * W].reshape(H, W)
    u = frame[H * W:H * W * 5 // 4].reshape(H // 2, W // 2)
    v = frame[H * W * 5 // 4:H * W * 3 // 2].reshape(H // 2, W // 2)
    return y, u, v


def _ref_stacks(ref: np.ndarray, gw: int, gh: int):
    """The edge-padded int32 reference planes, each as a stack of one."""
    planes = [torch.as_tensor(p.astype(np.int32))
              for p in i420_planes(ref, gw, gh)]
    return tuple(edge_pad_device(torch.nn.functional.pad(p, (PAD,) * 4))[None]
                 for p in planes)


def luma_mc_blocks_8bit_j(ref_pad, bx, by, mvx, mvy, ref_sel=None):
    """``ops/interpol.luma_mc_blocks`` with the centre half-pel sample j
    filtered from the rounded, clipped 8-bit b samples instead of the
    unrounded sums that 8.4.2.2.1 (8-241) prescribes: the control's
    precision below the standard's."""
    dev = ref_pad.device
    ref_flat, row_base, Hp, Wp = _flat_ref(ref_pad, ref_sel, bx)
    H, W = Hp - 2 * PAD, Wp - 2 * PAD
    fx = (mvx & 3).to(torch.int32)
    fy = (mvy & 3).to(torch.int32)
    xi = torch.clamp(bx + (mvx >> 2), -(PAD - 2), W + PAD - 7)
    yi = torch.clamp(by + (mvy >> 2), -(PAD - 2), H + PAD - 7)
    r9 = torch.arange(9, device=dev)
    rows = (yi[:, None] + PAD - 2 + row_base[:, None]) + r9[None, :]
    cols = (xi[:, None] + PAD - 2) + r9[None, :]
    R = ref_flat[rows[:, :, None].long(), cols[:, None, :].long()] \
        .to(torch.int32)
    H1 = _conv6_last(R, 4)
    V1 = _conv6_last(R.transpose(1, 2), 4)
    b9 = torch.clamp((H1 + 16) >> 5, 0, 255)                 # (N, 9, 4)
    b, s = b9[:, 2:6, :], b9[:, 3:7, :]
    h = torch.clamp((V1[:, 2:6, :] + 16) >> 5, 0, 255).transpose(1, 2)
    m = torch.clamp((V1[:, 3:7, :] + 16) >> 5, 0, 255).transpose(1, 2)
    j = torch.clamp((sum(t * b9[:, k:k + 4, :] for k, t in enumerate(_TAPS))
                     + 16) >> 5, 0, 255)
    G, Gx, Gy = R[:, 2:6, 2:6], R[:, 2:6, 3:7], R[:, 3:7, 2:6]
    bank = torch.stack([
        G, (G + b + 1) >> 1, b, (b + Gx + 1) >> 1,
        (G + h + 1) >> 1, (b + h + 1) >> 1, (b + j + 1) >> 1,
        (b + m + 1) >> 1,
        h, (h + j + 1) >> 1, j, (j + m + 1) >> 1,
        (h + Gy + 1) >> 1, (h + s + 1) >> 1, (j + s + 1) >> 1,
        (m + s + 1) >> 1], dim=1)
    case = (fy * 4 + fx).long()
    return bank[torch.arange(bank.shape[0], device=dev), case]


def decode_picture(pic: Picture, sps: SPS, pps: PPS, ref=None,
                   control: bool = False) -> np.ndarray:
    """The packed I420 frame (uint8, gw*16 x gh*16) of one picture.
    ``ref``: the packed I420 frame it predicts from (None for an IDR
    picture).  ``control``: decode with the error a faster decoder might
    be tempted by (``luma_mc_blocks_8bit_j``), which the limit has to
    catch."""
    gw, gh = sps.pic_width_in_mbs, sps.pic_height_in_mbs
    if pps.weighted_pred_flag:
        raise ValueError("the reference decodes no weighted prediction")
    sd = SliceData.create(gw, gh)
    for nal in pic.nals:
        r = BitReader(strip_emulation_prevention(nal))
        nh = N.parse_nal_header(r)
        sh = parse_slice_header(r, sps, pps, nal_ref_idc=nh.ref_idc,
                                is_idr=nh.is_idr)
        sid = sd._slice_count
        SliceDecoder(sps, pps, sd).decode_slice_data(r, sh)
        sd.wp[sid] = sh.pred_weights
    if not (sd.mb_kind >= 0).all():
        raise ValueError("picture with MBs that no slice holds")
    if (sd.mb_kind == MB_IBL).any():
        raise ValueError("the reference decodes AVC pictures only")

    inter_mask = (sd.mb_kind >= 3) & (sd.mb_kind != MB_IBL)
    has_inter = bool(inter_mask.any())
    ry = ru = rv = torch.zeros((1, 1, 1), dtype=torch.int32)
    if has_inter:
        if ref is None:
            raise ValueError("P picture without a reference frame")
        derive_mvs(sd)
        if (sd.ref_idx[inter_mask] > 0).any():
            raise ValueError("the reference holds one reference picture")
        ry, ru, rv = _ref_stacks(ref, gw, gh)
    H, W = gh * 16, gw * 16
    pcm_y = np.zeros((H, W), np.int32)
    pcm_u = np.zeros((H // 2, W // 2), np.int32)
    pcm_v = np.zeros((H // 2, W // 2), np.int32)
    for my, mx in zip(*np.nonzero(sd.mb_kind == MB_PCM)):
        pcm_y[my * 16:(my + 1) * 16, mx * 16:(mx + 1) * 16] = \
            sd.pcm_luma[my, mx]
        pcm_u[my * 8:(my + 1) * 8, mx * 8:(mx + 1) * 8] = \
            sd.pcm_chroma[my, mx, 0]
        pcm_v[my * 8:(my + 1) * 8, mx * 8:(mx + 1) * 8] = \
            sd.pcm_chroma[my, mx, 1]

    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dtype)

    inter_recon.luma_mc_blocks = luma_mc_blocks_8bit_j if control \
        else luma_mc_blocks
    padY, padU, padV, res_y, res_c = decode_frame_pre(
        t(sd.luma_ac), t(sd.luma_dc), t(sd.chroma_ac), t(sd.chroma_dc),
        t(sd.qp), t(sd.mb_kind == MB_I16, torch.bool), t(sd.mv),
        t(sd.ref_idx), ry, ru, rv,
        torch.zeros((gh, gw, 16, 16), dtype=torch.int32),
        torch.zeros((gh, gw, 2, 8, 8), dtype=torch.int32),
        t(sd.mb_kind), t(pcm_y), t(pcm_u), t(pcm_v),
        torch.full((2, 3, 4, 4), 16, dtype=torch.int32),
        torch.zeros((H, W), dtype=torch.int32),
        torch.zeros((2, H // 2, W // 2), dtype=torch.int32),
        torch.zeros((gh, gw), dtype=torch.bool),
        gw=gw, gh=gh, has_inter=has_inter, has_ibl=False,
        chroma_qp_off=pps.chroma_qp_index_offset)

    kind = np.where(sd.mb_kind == MB_I4X4, 0,
                    np.where(sd.mb_kind == MB_I16, 1, 2))
    if (kind < 2).any():
        constrained = bool(pps.constrained_intra_pred_flag)
        al, at = availability_masks(sd.slice_id, constrained, inter_mask)
        atr = availability_tr(sd.slice_id, constrained, inter_mask)
        padY, padU, padV = intra_reconstruct(
            (padY, padU, padV), res_y, res_c, t(kind), t(sd.i16_mode),
            t(sd.i4_modes), t(sd.chroma_mode), t(al, torch.bool),
            t(at, torch.bool), t(atr, torch.bool), gw=gw, gh=gh)

    if (sd.deblock_idc != 1).any():
        fmb_v, fmb_h, fint = _filter_flags(sd)
        rec = pack_deblock_record({
            "kind": sd.mb_kind, "qp": sd.qp, "mv": sd.mv,
            "ref_idx": sd.ref_idx,
            "nnz": sd.nnz_luma.reshape(gh, 4, gw, 4).transpose(0, 2, 1, 3),
            "alpha_off": sd.alpha_off, "beta_off": sd.beta_off,
            "fmb_v": fmb_v, "fmb_h": fmb_h, "fint": fint}, gw, gh)
        aux = deblock_params_dec_plain(
            torch.as_tensor(rec)[None], RECORD_OFFSETS,
            pps.chroma_qp_index_offset, gw=gw, gh=gh)[0]
        padY, padU, padV = deblock_frame_aux_plain((padY, padU, padV), aux,
                                                   gw=gw, gh=gh)
    return np.concatenate([
        p[PAD:-PAD, PAD:-PAD].to(torch.uint8).reshape(-1).numpy()
        for p in (padY, padU, padV)])
