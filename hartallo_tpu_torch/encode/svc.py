"""SVC encoder (Annex G subset): spatial layers (dyadic, same-resolution
or any other ratio) and one quality refinement layer, in torch.

Port of ``hartallo_tpu/encode/svc.py`` (reference
``hl_codec_264_encode.c:282-367`` for the SVC NAL prefix / extension
writing).  One ``Encoder`` per spatial layer, fed one picture of each
layer in turn, lowest layer first:

- base layer: plain AVC (SPS/PPS id 0), each slice preceded by a prefix
  NAL (type 14) carrying the SVC extension header;
- enhancement layers: subset SPS (Scalable Baseline, id L) + PPS id L.
  IDR pictures are all-I_BL (inter-layer intra from the 16-phase
  upsampled base reconstruction, G.8.6.2); P pictures either infer every
  MB's motion from the base layer (base_mode_flag, G.8.6.1) with
  inter-layer residual prediction where it shrinks the residual
  (G.8.6.3), or, with ``svc_inter_layer_p`` off or no base motion yet,
  are coded within the layer and rewrapped as NAL 20;
- ``quality_layers`` 2 on a single layer: each picture is followed by a
  quality_id 1 refinement NAL (pixel-domain I_BL on IDR pictures,
  transform-coefficient accumulation on P pictures, G.8.5.1).

Temporal scalability (``temporal_layers`` 2) makes alternate P pictures
non-reference with temporal_id 1.  Intra-in-P stays off inside layer
stacks (see ``SvcEncoder.__init__``).  Every reconstruction is deblocked
by the encoder's ``_deblock_recon``: the CUDA deblock kernel on a CUDA
device, its plain twin on the CPU.  All sample arithmetic is int32 on the
encoder's device; the CAVLC packing and the motion inference are the
port's host copies.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from hartallo_tpu_torch.api import CodecConfig, EncodeResult
from hartallo_tpu_torch.bitio import BitWriter, find_nal_units, \
    insert_emulation_prevention
from hartallo_tpu_torch.core.tables import QP_SCALE_CHROMA
from hartallo_tpu_torch.decode import nal as N
from hartallo_tpu_torch.decode.d_pool import (accumulated_residual_planes_np,
                                              residual_planes_np)
from hartallo_tpu_torch.decode.intra_recon import PAD
from hartallo_tpu_torch.decode.mc_decode_fast import (identity_mc_inputs,
                                                      mc_recon_fast)
from hartallo_tpu_torch.decode.params import (PPS, SPS, SpsSvcExt,
                                              write_subset_sps)
from hartallo_tpu_torch.decode.slice_decode import MB_IBL, MB_PBL
from hartallo_tpu_torch.decode.sliceheader import SliceHeader, \
    write_slice_header
from hartallo_tpu_torch.encode.encoder import (Encoder, _annexb,
                                               _guess_level,
                                               _planes_from_mbs)
from hartallo_tpu_torch.encode.intra_encode import (_blocks_of_mb,
                                                    _mb_of_blocks,
                                                    chroma_blocks,
                                                    chroma_plane)
from hartallo_tpu_torch.encode.p_body_fast import halfpel_planes_fast
from hartallo_tpu_torch.encode.slice_encode import FramePacker
from hartallo_tpu_torch.ops.transform import (chroma_dc_descale,
                                              dequant_4x4, forward_dct_4x4,
                                              forward_hadamard_quant_dc_chroma,
                                              forward_quant_4x4,
                                              inverse_transform_4x4)
from hartallo_tpu_torch.ops.wide import pad_edge
from hartallo_tpu_torch.svc.motion import infer_motion
from hartallo_tpu_torch.svc.upsample import (upsample_plane,
                                             upsample_residual_plane_np)


def _ilp_predict(refY, refU, refV, mvf, *, gw: int, gh: int):
    """Inter prediction planes from the layer's own (padded) reference
    with per-4x4 inferred MVs: the decoder's MC, bit-exact.  The half-pel
    stack (``halfpel_planes_fast``) and the MC (``mc_recon_fast`` with
    slot 0, identity weights, no residual and every MB inter) are the
    decoder's kernels on a CUDA device, their plain twins on the CPU."""
    H, W = gh * 16, gw * 16
    slot, wp_l, wp_c, res_y, res_c, inter = identity_mc_inputs(
        gw, gh, refY.device)
    pY, pU, pV = mc_recon_fast(
        halfpel_planes_fast(refY)[None], refU.contiguous()[None],
        refV.contiguous()[None], mvf.contiguous(), slot, wp_l, wp_c, res_y,
        res_c, inter, gw=gw, gh=gh)
    return (pY[PAD:PAD + H, PAD:PAD + W],
            pU[PAD:PAD + H // 2, PAD:PAD + W // 2],
            pV[PAD:PAD + H // 2, PAD:PAD + W // 2])


def _edge_repad(plane, pad=PAD):
    """Re-replicate the pad zone from the (final, deblocked) interior: the
    decoder's reference ring edge-pads AFTER deblocking, and MC windows
    read the pad, so the encoder's reference planes must match."""
    return pad_edge(plane[pad:-pad, pad:-pad].to(torch.int32), pad)


def _prefix_nal(svc: N.NalSvcExt, ref_idc: int) -> bytes:
    w = BitWriter()
    N.write_nal_header(w, ref_idc, N.NAL_PREFIX, svc)
    if ref_idc != 0:
        w.u1(0)   # store_ref_base_pic_flag
        w.u1(0)   # additional_prefix_nal_unit_extension_flag
    w.write_rbsp_trailing_bits()
    return _annexb(insert_emulation_prevention(w.getvalue()))


def _residual_planes_from_coeffs(coeffs, chroma_qp_off):
    """rS planes of an encoded picture from its quantized coefficients
    (decoder-identical: the numpy dequant + IDCT of ``d_pool``; inter MBs
    only)."""
    arrays, qp, mb_kind = coeffs
    gh, gw = mb_kind.shape
    sdl = SimpleNamespace(
        gh=gh, gw=gw, qp=np.asarray(qp, np.int32),
        mb_kind=np.asarray(mb_kind),
        luma_ac=np.asarray(arrays["luma_ac"], np.int32),
        chroma_ac=np.asarray(arrays["chroma_ac"], np.int32),
        chroma_dc=np.asarray(arrays["chroma_dc"], np.int32))
    return residual_planes_np(sdl, chroma_qp_off)


def _tiles(plane, s: int):
    """(gh*s, gw*s) plane -> (gh, gw, s, s) MB tiles."""
    H, W = plane.shape
    return plane.reshape(H // s, s, W // s, s).permute(0, 2, 1, 3)


def _chroma_tiles(u, v):
    """Two (H/2, W/2) planes -> (gh, gw, 2, 8, 8)."""
    return torch.stack([_tiles(u, 8), _tiles(v, 8)], dim=2)


def _interior(plane, h: int, w: int):
    return plane[PAD:PAD + h, PAD:PAD + w]


class SvcEncoder:
    """Drives one Encoder per spatial layer on ``device``; pictures are fed
    per layer in increasing order (the reference's hl_codec_add_layer
    call pattern)."""

    def __init__(self, config: CodecConfig, *, device="cuda"):
        self.cfg = config
        self.device = torch.device(device)
        self.layers: List[Encoder] = []
        self._call = 0
        self.qenc: Optional[Encoder] = None   # quality_id=1 chain state
        for li, (w, h) in enumerate(config.layers):
            sub = CodecConfig(**{**config.__dict__, "layers": []})
            sub.width, sub.height = w, h
            # intra-in-P stays off inside SVC layer stacks: a mixed
            # intra/inter base picture would make enhancement I_BL MBs
            # resample across intra/inter borders, where the spec (and
            # the reference decoder) constructs "not available" inter
            # samples before filtering (G.8.6.2.2.2), a path neither
            # encoder implements.  All-inter / all-intra base pictures
            # sidestep it.
            sub.intra_in_p = False
            enc = Encoder(sub, device=self.device)
            enc._svc_layer = li
            enc._svc_nlayers = len(config.layers)
            self.layers.append(enc)

    def _t(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

    def _source(self, frame, width, height):
        """(y, u, v) int32 planes of an I420 frame on the device."""
        buf = np.frombuffer(bytes(frame), np.uint8) if not \
            isinstance(frame, np.ndarray) else np.asarray(frame).ravel()
        ysz = width * height
        y = buf[:ysz].reshape(height, width)
        u = buf[ysz:ysz + ysz // 4].reshape(height // 2, width // 2)
        v = buf[ysz + ysz // 2 - ysz // 4:].reshape(height // 2, width // 2)
        return tuple(self._t(p) for p in (y, u, v))

    def _qp_maps(self, qp_val, pps, gw, gh):
        qp = np.full((gh, gw), qp_val, np.int32)
        qpc = QP_SCALE_CHROMA[np.clip(qp + pps.chroma_qp_index_offset,
                                      0, 51)]
        return qp, qpc, self._t(qp), self._t(qpc)

    def _upsampled_base(self, base: Encoder, H: int, W: int):
        """The base layer's current reconstruction, upsampled to (H, W)."""
        bY, bU, bV = base._ref_planes
        bH, bW = bY.shape[0] - 2 * PAD, bY.shape[1] - 2 * PAD
        return (upsample_plane(_interior(bY, bH, bW), H, W),
                upsample_plane(_interior(bU, bH // 2, bW // 2), H // 2,
                               W // 2, chroma=True),
                upsample_plane(_interior(bV, bH // 2, bW // 2), H // 2,
                               W // 2, chroma=True))

    @staticmethod
    def _luma_quant(res, qpj, intra):
        """Forward transform, quantisation and reconstruction of (gh, gw,
        16, 16) luma residual MBs: (levels (gh, gw, 16, 4, 4), residual
        samples (gh, gw, 16, 16))."""
        gh, gw = qpj.shape
        wq = forward_quant_4x4(forward_dct_4x4(_blocks_of_mb(res)),
                               qpj[..., None], intra)
        d = dequant_4x4(wq, qpj[..., None].expand(gh, gw, 16))
        return wq, _mb_of_blocks(inverse_transform_4x4(d))

    @staticmethod
    def _chroma_quant(resc, qpcj, intra_dc, intra_ac):
        """The same for (gh, gw, 2, 8, 8) chroma residuals: (DC levels
        (gh, gw, 2, 2, 2), AC levels (gh, gw, 2, 4, 4, 4))."""
        wc = forward_dct_4x4(chroma_blocks(resc))
        dc2 = wc[..., 0, 0].reshape(*wc.shape[:-3], 2, 2)
        dcq = forward_hadamard_quant_dc_chroma(dc2, qpcj[..., None],
                                               intra_dc)
        acq = forward_quant_4x4(wc, qpcj[..., None, None], intra_ac,
                                skip_dc=True)
        return dcq, acq

    @staticmethod
    def _chroma_recon(dcq, acq, qpcj):
        gh, gw = qpcj.shape
        dcd = chroma_dc_descale(dcq, qpcj[..., None])
        dd = dequant_4x4(acq, qpcj[..., None, None].expand(gh, gw, 2, 4))
        dd[..., 0, 0] = dcd.reshape(gh, gw, 2, 4)
        return chroma_plane(inverse_transform_4x4(dd))

    @staticmethod
    def _arrays(wq, dcq, acq, gw, gh):
        return {
            "use_i16": np.zeros((gh, gw), np.int32),
            "luma_ac": wq.cpu().numpy(),
            "luma_dc": np.zeros((gh, gw, 4, 4), np.int32),
            "chroma_dc": dcq.cpu().numpy(),
            "chroma_ac": acq.cpu().numpy(),
            "i16_mode": np.zeros((gh, gw), np.int32),
            "i4_modes": np.zeros((gh, gw, 16), np.int32),
            "chroma_mode": np.zeros((gh, gw), np.int32),
        }

    def _recon_planes(self, enc: Encoder, arrays, qp, kind_for_bs, rec_y,
                      rec_c, gw, gh):
        """PAD-padded recon planes of (gh, gw, ...) MB tiles, deblocked
        when the layer deblocks, then edge re-padded."""
        planes = tuple(F.pad(_planes_from_mbs(m), (PAD,) * 4)
                       for m in (rec_y, rec_c[:, :, 0], rec_c[:, :, 1]))
        if enc.cfg.deblock:
            planes = enc._deblock_recon(arrays, qp, kind_for_bs, planes,
                                        gw, gh)
        return tuple(_edge_repad(p) for p in planes)

    # ------------------------------------------------------------------
    def encode_frame(self, frame, width, height) -> EncodeResult:
        li = self._call % len(self.layers)
        self._call += 1
        enc = self.layers[li]
        w, h = self.cfg.layers[li]
        if li == 0:
            r = self._encode_base(enc, frame, w, h)
        else:
            r = self._encode_enh(enc, li, frame, w, h)
        if (self.cfg.quality_layers >= 2 and len(self.layers) == 1
                and self.cfg.temporal_layers == 1):
            q = self._encode_quality_picture(enc, li, frame, w, h,
                                             r.keyframe)
            r = EncodeResult(data=r.data + q, headers=r.headers,
                             keyframe=r.keyframe,
                             temporal_id=r.temporal_id)
        return r

    # ------------------------------------------------------------------
    def _encode_base(self, enc: Encoder, frame, w, h) -> EncodeResult:
        r = enc.encode_frame(frame, w, h)
        svc = N.NalSvcExt(idr_flag=1 if r.keyframe else 0,
                          no_inter_layer_pred_flag=1,
                          dependency_id=0, quality_id=0,
                          temporal_id=r.temporal_id)
        ref_idc = 3 if r.keyframe else (0 if r.temporal_id else 2)
        prefix = _prefix_nal(svc, ref_idc)
        return EncodeResult(data=prefix + r.data, headers=r.headers,
                            keyframe=r.keyframe,
                            temporal_id=r.temporal_id)

    # ------------------------------------------------------------------
    def _setup_enh(self, enc: Encoder, li: int, width, height) -> None:
        gw, gh = (width + 15) // 16, (height + 15) // 16
        sps = SPS(profile_idc=83, constraint_set_flags=0,
                  level_idc=_guess_level(width, height),
                  seq_parameter_set_id=li,
                  log2_max_frame_num_minus4=4, pic_order_cnt_type=2,
                  max_num_ref_frames=1,
                  pic_width_in_mbs_minus1=gw - 1,
                  pic_height_in_map_units_minus1=gh - 1)
        sps.svc = SpsSvcExt(
            inter_layer_deblocking_filter_control_present_flag=1,
            slice_header_restriction_flag=1)
        pps = PPS(pic_parameter_set_id=li, seq_parameter_set_id=li,
                  deblocking_filter_control_present_flag=1,
                  pic_init_qp_minus26=max(-26, min(25, enc.cfg.qp - 26)))
        enc.sps, enc.pps = sps, pps
        w = BitWriter()
        N.write_nal_header(w, 3, N.NAL_SUBSET_SPS)
        write_subset_sps(w, sps)
        sps_nal = insert_emulation_prevention(w.getvalue())
        w = BitWriter()
        N.write_nal_header(w, 3, N.NAL_PPS)
        pps.write(w)
        pps_nal = insert_emulation_prevention(w.getvalue())
        enc._headers = _annexb(sps_nal) + _annexb(pps_nal)

    # ------------------------------------------------------------------
    def _encode_enh(self, enc: Encoder, li: int, frame, width,
                    height) -> EncodeResult:
        if enc.sps is None:
            self._setup_enh(enc, li, width, height)
        sps, pps = enc.sps, enc.pps
        gw, gh = sps.pic_width_in_mbs, sps.pic_height_in_mbs
        W, H = gw * 16, gh * 16

        is_idr = enc.gop_left <= 0 or enc._ref_planes is None
        if not is_idr:
            return self._encode_enh_p(enc, li, frame, width, height)
        enc.gop_left = max(enc.cfg.gop_size, 1)
        enc.gop_left -= 1
        enc.frame_num = 0
        enc._poc_cnt = 1     # IDR is frame 0 of the GOP (temporal phase)

        base = self.layers[li - 1]
        if base._ref_planes is None:
            raise ValueError("enhancement layer encoded before base")
        up_y, up_u, up_v = self._upsampled_base(base, H, W)
        y, u, v = self._source(frame, width, height)
        qp, qpc, qpj, qpcj = self._qp_maps(enc.cfg.qp, pps, gw, gh)

        # residual against the upsampled base (I_BL for every MB)
        up_mb = _tiles(up_y, 16)
        wq, rec = self._luma_quant(_tiles(y, 16) - up_mb, qpj, True)
        rec_y = torch.clamp(up_mb + rec, 0, 255)
        up_c = _chroma_tiles(up_u, up_v)
        dcq, acq = self._chroma_quant(_chroma_tiles(u, v) - up_c, qpcj,
                                      True, True)
        rec_c = torch.clamp(up_c + self._chroma_recon(dcq, acq, qpcj), 0,
                            255)

        arrays = self._arrays(wq, dcq, acq, gw, gh)
        mb_kind = np.full((gh, gw), MB_IBL, np.int8)
        payload = self._pack_ibl_frame(enc, li, arrays, qp, mb_kind)

        # recon for the layer DPB (deblock: I_BL counts as intra)
        enc._ref_planes = self._recon_planes(
            enc, arrays, qp, np.zeros((gh, gw), np.int8), rec_y, rec_c,
            gw, gh)
        enc.frame_num = (enc.frame_num + 1) % sps.max_frame_num
        enc.frame_idx += 1
        return EncodeResult(data=_annexb(payload), headers=enc._headers,
                            keyframe=True)

    # ------------------------------------------------------------------
    def _pack_ibl_frame(self, enc: Encoder, li: int, arrays, qp,
                        mb_kind, quality: int = 0,
                        ref_dqid: int = -1) -> bytes:
        sps, pps = enc.sps, enc.pps
        gw, gh = sps.pic_width_in_mbs, sps.pic_height_in_mbs
        hdr = SliceHeader(
            first_mb_in_slice=0, slice_type=7,
            pic_parameter_set_id=pps.pic_parameter_set_id,
            frame_num=0, idr_pic_id=enc.idr_pic_id,
            slice_qp_delta=int(qp[0, 0]) - pps.pic_init_qp,
            disable_deblocking_filter_idc=0 if enc.cfg.deblock else 1,
            ref_layer_dq_id=ref_dqid if ref_dqid >= 0 else (li - 1) << 4,
            disable_inter_layer_deblocking_filter_idc=1,
            adaptive_base_mode_flag=0, default_base_mode_flag=1,
            adaptive_residual_prediction_flag=0,
            default_residual_prediction_flag=0)
        enc.idr_pic_id = (enc.idr_pic_id + 1) % 16
        svc = N.NalSvcExt(idr_flag=1, no_inter_layer_pred_flag=0,
                          dependency_id=li, quality_id=quality,
                          temporal_id=0)
        w = BitWriter()
        N.write_nal_header(w, 3, N.NAL_SLICE_EXT, svc)
        write_slice_header(w, hdr, sps, pps, nal_ref_idc=3, is_idr=True,
                           svc_ext=True, no_inter_layer_pred=False,
                           quality_id=quality)
        packer = FramePacker(gw, gh, arrays, qp, mb_kind)
        qp_state = [hdr.slice_qp(pps)]
        for my in range(gh):
            for mx in range(gw):
                packer.write_ibl_mb(w, mx, my, qp_state, 0)
        w.write_rbsp_trailing_bits()
        return insert_emulation_prevention(w.getvalue())

    # ------------------------------------------------------------------
    def _encode_enh_p(self, enc: Encoder, li: int, frame, width,
                      height) -> EncodeResult:
        base = self.layers[li - 1]
        if self.cfg.svc_inter_layer_p and base._last_motion is not None \
                and enc._ref_planes is not None and enc.sps is not None:
            return self._encode_enh_p_ilp(enc, li, frame, width, height)
        return self._encode_enh_p_rewrap(enc, li, frame, width, height)

    # ------------------------------------------------------------------
    def _encode_enh_p_ilp(self, enc: Encoder, li: int, frame, width,
                          height) -> EncodeResult:
        """EP picture with base_mode_flag=1 on every macroblock: motion is
        inferred from the base layer (G.8.6.1: RSRC index mapping for
        dyadic / same-resolution pairs, the full ESS derivation for any
        other ratio), prediction runs on the layer's own reference
        picture, and only CBP + residual are coded (no mb_type, no mvd).

        Mirrors the reference encoder's design intent
        (hl_codec_264_rdo.c:1325 base_mode_flag=1 on EP MBs)."""
        base = self.layers[li - 1]
        sps, pps = enc.sps, enc.pps
        gw, gh = sps.pic_width_in_mbs, sps.pic_height_in_mbs
        W, H = gw * 16, gh * 16
        same_res = (gw, gh) == (base.sps.pic_width_in_mbs,
                                base.sps.pic_height_in_mbs)

        bmv, bref, bintra = base._last_motion
        mv_il, ref_il, ibl = infer_motion(
            bmv, bref.astype(np.int32), bintra, gw, gh)

        # ---- prediction: inter MC on the own reference; I_BL on the MBs
        # whose base MB is intra
        refY, refU, refV = enc._ref_planes
        pY, pU, pV = _ilp_predict(refY, refU, refV,
                                  self._t(mv_il.reshape(gh * gw * 16, 2)),
                                  gw=gw, gh=gh)
        if ibl.any():
            up_y, up_u, up_v = self._upsampled_base(base, H, W)
            ibl_t = self._t(ibl, torch.bool)
            m16 = ibl_t.repeat_interleave(16, 0).repeat_interleave(16, 1)
            m8 = ibl_t.repeat_interleave(8, 0).repeat_interleave(8, 1)
            pY = torch.where(m16, up_y, pY)
            pU = torch.where(m8, up_u, pU)
            pV = torch.where(m8, up_v, pV)

        # ---- residual transform / quant (intra rounding on I_BL MBs)
        y, u, v = self._source(frame, width, height)
        qp, qpc, qpj, qpcj = self._qp_maps(enc.cfg.qp, pps, gw, gh)
        intra_mb = self._t(ibl, torch.bool)
        pred_mb = _tiles(pY, 16)
        res = _tiles(y, 16) - pred_mb
        pred_c = _chroma_tiles(pU, pV)
        resc = _chroma_tiles(u, v) - pred_c

        # ---- inter-layer residual prediction (G.8.6.3): flag 1 where
        # subtracting the base layer's rS shrinks the luma residual; the
        # recon mirrors the decoder's clip3 accumulation.  Spatial layer
        # pairs resample the base residual first (G-334..G-342)
        res_pred = None
        base_enc = self.layers[li - 1]
        if base_enc._last_coeffs is not None and self.cfg.svc_residual_pred:
            bry, brcb, brcr = _residual_planes_from_coeffs(
                base_enc._last_coeffs, pps.chroma_qp_index_offset)
            if not same_res:
                bry = upsample_residual_plane_np(bry, H, W)
                brcb = upsample_residual_plane_np(brcb, H // 2, W // 2,
                                                  chroma=True)
                brcr = upsample_residual_plane_np(brcr, H // 2, W // 2,
                                                  chroma=True)
            bres_y_mb = _tiles(self._t(bry), 16)
            bres_c_mb = _chroma_tiles(self._t(brcb), self._t(brcr))
            sad_plain = res.abs().sum(dim=(2, 3))
            sad_pred = (res - bres_y_mb).abs().sum(dim=(2, 3))
            rp = (sad_pred < sad_plain) & ~intra_mb
            res_pred = rp.cpu().numpy()
            rp16 = rp[:, :, None, None]
            rp8 = rp[:, :, None, None, None]
            res = torch.where(rp16, res - bres_y_mb, res)
            resc = torch.where(rp8, resc - bres_c_mb, resc)
        wq, rec = self._luma_quant(res, qpj, intra_mb[..., None])
        dcq, acq = self._chroma_quant(resc, qpcj, intra_mb[..., None],
                                      intra_mb[..., None, None])
        recc = self._chroma_recon(dcq, acq, qpcj)
        if res_pred is not None:
            rec = torch.where(rp16, torch.clamp(rec + bres_y_mb, -255, 255),
                              rec)
            recc = torch.where(rp8, torch.clamp(recc + bres_c_mb, -255, 255),
                               recc)
        rec_y = torch.clamp(pred_mb + rec, 0, 255)
        rec_c = torch.clamp(pred_c + recc, 0, 255)

        arrays = self._arrays(wq, dcq, acq, gw, gh)
        arrays["mv44"] = mv_il
        mb_kind = np.where(ibl, MB_IBL, MB_PBL).astype(np.int8)

        two_t = enc.cfg.temporal_layers >= 2
        tid = int(enc._poc_cnt % 2) if two_t else 0
        enc._poc_cnt += 1
        payload = self._pack_ep_frame(enc, li, arrays, qp, mb_kind,
                                      tid=tid, res_pred=res_pred)

        # I_BL counts as intra, inferred MBs as inter (mv-based bS)
        planes = self._recon_planes(
            enc, arrays, qp, np.where(ibl, 0, MB_PBL).astype(np.int8),
            rec_y, rec_c, gw, gh)
        if tid == 0:
            # T1 pictures are non-reference (droppable): only T0 recon
            # enters the reference/motion state
            enc._ref_planes = planes
            enc._last_motion = (mv_il, ref_il.astype(np.int8), ibl)
            enc.frame_num = (enc.frame_num + 1) % sps.max_frame_num
        enc.gop_left -= 1
        enc.frame_idx += 1
        return EncodeResult(data=_annexb(payload), headers=b"",
                            keyframe=False, temporal_id=tid)

    # ------------------------------------------------------------------
    def _encode_quality_picture(self, base_enc: Encoder, li: int, frame,
                                width, height, is_idr: bool) -> bytes:
        """quality_id=1 refinement NAL for the picture just encoded by
        ``base_enc`` (G.8.5.1 family): IDR pictures refine the base recon
        in the pixel domain (same-resolution I_BL), P pictures refine the
        TRANSFORM COEFFICIENTS, levels quantized at qp - quality_qp_delta
        accumulating with the base picture's levels before one inverse
        transform (sTCoeff, G-127..G-130; reference
        hl_codec_264_decode_svc.c:92-146).  The refinement chain keeps its
        own reference recon (MGS semantics)."""
        qe = self.qenc
        if qe is None:
            sub = CodecConfig(**{**self.cfg.__dict__, "layers": [],
                                 "quality_layers": 1})
            sub.width, sub.height = width, height
            sub.qp = max(0, min(51, self.cfg.qp -
                                self.cfg.quality_qp_delta))
            sub.intra_in_p = False
            qe = Encoder(sub, device=self.device)
            # quality layers need a subset SPS (the NAL-20 slice header
            # is parsed against the SPS's svc extension); ids offset by
            # 8 to stay clear of the spatial layers'
            self._setup_enh(qe, li + 8, width, height)
            self.qenc = qe
        sps, pps = qe.sps, qe.pps
        gw, gh = sps.pic_width_in_mbs, sps.pic_height_in_mbs
        W, H = gw * 16, gh * 16
        qp, qpc, qpj, qpcj = self._qp_maps(qe.cfg.qp, pps, gw, gh)
        y, u, v = self._source(frame, width, height)

        bY, bU, bV = base_enc._ref_planes   # base recon of THIS picture
        if is_idr:
            # pixel-domain I_BL refinement of the (same-res) base recon
            pY, pU, pV = (_interior(bY, H, W), _interior(bU, H // 2, W // 2),
                          _interior(bV, H // 2, W // 2))
        else:
            refY, refU, refV = qe._ref_planes
            mvf = self._t(np.asarray(base_enc._last_motion[0], np.int32)
                          .reshape(gh * gw * 16, 2))
            pY, pU, pV = _ilp_predict(refY, refU, refV, mvf, gw=gw, gh=gh)
        intra_round = bool(is_idr)
        pred_mb = _tiles(pY, 16)
        pred_c = _chroma_tiles(pU, pV)
        res = _tiles(y, 16) - pred_mb
        resc = _chroma_tiles(u, v) - pred_c
        if not is_idr:
            # refinement target: the residual the base coefficients do
            # not already represent (decision domain; the recon below is
            # exact coefficient accumulation)
            bry, brcb, brcr = _residual_planes_from_coeffs(
                base_enc._last_coeffs, pps.chroma_qp_index_offset)
            res = res - _tiles(self._t(bry), 16)
            resc = resc - _chroma_tiles(self._t(brcb), self._t(brcr))

        wq, rec = self._luma_quant(res, qpj, intra_round)
        dcq, acq = self._chroma_quant(resc, qpcj, intra_round, intra_round)
        if is_idr:
            # reconstruct exactly like the decoder's I_BL path
            rec_y = torch.clamp(pred_mb + rec, 0, 255)
            rec_c = torch.clamp(
                pred_c + self._chroma_recon(dcq, acq, qpcj), 0, 255)
        else:
            # exact decoder recon: sTCoeff accumulation then one IDCT,
            # clip3 per the respred accumulation the decoder rides
            barr, bqp, _ = base_enc._last_coeffs
            ry, rcb, rcr = accumulated_residual_planes_np(
                (barr["luma_ac"], barr["chroma_ac"], barr["chroma_dc"],
                 bqp),
                (wq.cpu().numpy(), acq.cpu().numpy(), dcq.cpu().numpy(),
                 qp), pps.chroma_qp_index_offset)
            ry = np.clip(ry, -255, 255)
            rc = np.clip(np.stack([rcb, rcr]), -255, 255)
            rec_y = torch.clamp(pred_mb + _tiles(self._t(ry), 16), 0, 255)
            rec_c = torch.clamp(
                pred_c + _chroma_tiles(self._t(rc[0]), self._t(rc[1])),
                0, 255)

        arrays = self._arrays(wq, dcq, acq, gw, gh)
        if is_idr:
            mb_kind = np.full((gh, gw), MB_IBL, np.int8)
            qe.frame_num = 0
            payload = self._pack_ibl_frame(qe, li, arrays, qp, mb_kind,
                                           quality=1, ref_dqid=li << 4)
        else:
            arrays["mv44"] = np.asarray(base_enc._last_motion[0], np.int32)
            mb_kind = np.full((gh, gw), MB_PBL, np.int8)
            payload = self._pack_ep_frame(qe, li, arrays, qp, mb_kind,
                                          tid=0, res_pred=None,
                                          quality=1, ref_dqid=li << 4)

        kind_for_bs = np.zeros((gh, gw), np.int8) if is_idr \
            else np.full((gh, gw), MB_PBL, np.int8)
        qe._ref_planes = self._recon_planes(qe, arrays, qp, kind_for_bs,
                                            rec_y, rec_c, gw, gh)
        qe.frame_num = (qe.frame_num + 1) % sps.max_frame_num
        if is_idr:
            return qe._headers + _annexb(payload)
        return _annexb(payload)

    # ------------------------------------------------------------------
    def _pack_ep_frame(self, enc: Encoder, li: int, arrays, qp,
                       mb_kind, tid: int = 0, res_pred=None,
                       quality: int = 0, ref_dqid: int = -1) -> bytes:
        """EP slice: every MB coded with inferred base_mode (skip-run 0 +
        the I_BL-shaped CBP/residual syntax, G.7.3.6.2)."""
        sps, pps = enc.sps, enc.pps
        gw, gh = sps.pic_width_in_mbs, sps.pic_height_in_mbs
        hdr = SliceHeader(
            first_mb_in_slice=0, slice_type=5,
            pic_parameter_set_id=pps.pic_parameter_set_id,
            frame_num=enc.frame_num,
            slice_qp_delta=int(qp[0, 0]) - pps.pic_init_qp,
            disable_deblocking_filter_idc=0 if enc.cfg.deblock else 1,
            ref_layer_dq_id=ref_dqid if ref_dqid >= 0 else (li - 1) << 4,
            disable_inter_layer_deblocking_filter_idc=1,
            adaptive_base_mode_flag=0, default_base_mode_flag=1,
            adaptive_residual_prediction_flag=(
                1 if res_pred is not None else 0),
            default_residual_prediction_flag=0)
        ref_idc = 0 if tid else 2
        svc = N.NalSvcExt(idr_flag=0, no_inter_layer_pred_flag=0,
                          dependency_id=li, quality_id=quality,
                          temporal_id=tid)
        w = BitWriter()
        N.write_nal_header(w, ref_idc, N.NAL_SLICE_EXT, svc)
        write_slice_header(w, hdr, sps, pps, nal_ref_idc=ref_idc,
                           is_idr=False, svc_ext=True,
                           no_inter_layer_pred=False,
                           quality_id=quality)
        packer = FramePacker(gw, gh, arrays, qp, mb_kind)
        qp_state = [hdr.slice_qp(pps)]
        for my in range(gh):
            for mx in range(gw):
                w.ue(0)                     # mb_skip_run
                if res_pred is not None:
                    w.u1(int(res_pred[my, mx]))
                packer.write_ibl_mb(w, mx, my, qp_state, 0)
        w.write_rbsp_trailing_bits()
        return insert_emulation_prevention(w.getvalue())

    # ------------------------------------------------------------------
    def _encode_enh_p_rewrap(self, enc: Encoder, li: int, frame, width,
                             height) -> EncodeResult:
        """P frame within the enhancement layer, wrapped as NAL 20 with
        no_inter_layer_pred = 1.  EVERY slice NAL of the frame is
        rewrapped (multi-slice and FMO layouts produce several)."""
        r = enc.encode_frame(frame, width, height)
        svc = N.NalSvcExt(idr_flag=0, no_inter_layer_pred_flag=1,
                          dependency_id=li, quality_id=0,
                          temporal_id=r.temporal_id)
        ref_idc = 0 if r.temporal_id else 2
        out = b""
        for s0, e0 in find_nal_units(r.data):
            nal = r.data[s0:e0]
            # replace the 1-byte AVC NAL header with the 4-byte SVC
            # extension header (type 20)
            w = BitWriter()
            N.write_nal_header(w, ref_idc, N.NAL_SLICE_EXT, svc)
            out += _annexb(w.getvalue() + nal[1:])
        return EncodeResult(data=out, headers=b"",
                            keyframe=False, temporal_id=r.temporal_id)
