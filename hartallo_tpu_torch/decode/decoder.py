"""Decoder front end: NAL dispatch -> host slice parse -> GOP-batched
pixel pipeline on the decoder's device -> output frames.

Port of the AVC batched path of ``hartallo_tpu/decode/decoder.py``.  The
host parse (``native`` CAVLC, ``mv``, ``dpb``, ``poc``, ``fmo``, the
parameter sets and slice headers) is the port's copy of the JAX
package's host modules.  Completed pictures are queued and decoded a
batch at a time, with the DPB held on the device as a ring of half-pel
reference stacks:

- a picture ``d_pool.eligible`` accepts (the rule is the JAX package's)
  goes to ``d_gop_fast.decode_gop_fast``: the CUDA kernel on a CUDA
  device, its plain torch twin on the CPU;
- any other picture goes to the GOP scan ``d_gop.decode_gop``, as in the
  JAX package (for example a P picture with explicit weighted
  prediction).  Unlike the JAX package, the kernel takes a picture with
  any number of intra MBs or residual blocks (every 720p and 1080p IDR
  picture, which the Pallas kernel's capacities send to the scan).

``stats`` counts the pictures of each route.  PCM, I_BL, scaling lists,
residual prediction, quality refinement and SVC NAL units need the
general decode path, which is not ported: they raise
NotImplementedError, even in tolerant mode.

Reference parity: ``hl_codec_264.c:79-397`` (_decode),
``hl_codec_264_nal.c`` (slice pipeline), ``hl_codec_264_decode_avc.c``
(per-picture order).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from hartallo_tpu_torch.api import DecodeResult
from hartallo_tpu_torch.bitio import BitReader, find_nal_units, \
    strip_emulation_prevention
from hartallo_tpu_torch.decode import nal as N
from hartallo_tpu_torch.decode.dpb import DPB, Frame
from hartallo_tpu_torch.decode.params import PPS, SPS, effective_weight4x4
from hartallo_tpu_torch.decode.poc import PocDecoder
from hartallo_tpu_torch.decode.slice_decode import (MB_IBL, MB_PCM,
                                                    SliceData, SliceDecoder)
from hartallo_tpu_torch.decode.sliceheader import SliceHeader, \
    parse_slice_header
from hartallo_tpu_torch.util import log
from hartallo_tpu_torch.decode import d_pool
from hartallo_tpu_torch.decode.d_fused import pack_slice_arrays
from hartallo_tpu_torch.decode.d_gop import (decode_gop, ring_shapes,
                                             split_gop_out)
from hartallo_tpu_torch.decode.d_gop_fast import (decode_gop_fast,
                                                  payload_to, stack_payload)
from hartallo_tpu_torch.decode.intra_recon import (availability_masks,
                                                   availability_tr)

BATCH_K = 16     # pictures per batch

GENERAL_PATH = ("general decode path not ported: PCM / I_BL / scaling "
                "lists / residual prediction / quality refinement")


class _Layer:
    def __init__(self):
        self.cur: Optional[SliceData] = None
        self.hdr: Optional[SliceHeader] = None
        self.nal: Optional[N.NalHeader] = None
        self.dpb = DPB()
        self.poc = PocDecoder()
        self.ring = None                 # (ringY, ringU, ringV) tensors
        self.ring_key = None             # (gw, gh, S, chroma_qp_off)
        self.jobs = []                   # queued _Job records


class _Job:
    __slots__ = ("packed", "wslot", "has_intra", "out", "gw", "gh", "fast")

    def __init__(self, packed, wslot, has_intra, gw, gh, fast=None):
        self.packed = packed             # dense buffer (scan route) or None
        self.wslot = wslot
        self.has_intra = has_intra
        self.out = None                  # (_BatchOut, row index)
        self.gw, self.gh = gw, gh
        self.fast = fast                 # d_pool.FastFrame (kernel route)


class _BatchOut:
    """One batch's output, copied to the host once and shared by every
    frame of the batch."""
    __slots__ = ("dev", "host")

    def __init__(self, dev):
        self.dev = dev
        self.host = None

    def fetch(self) -> np.ndarray:
        if self.host is None:
            self.host = self.dev.cpu().numpy()
            self.dev = None
        return self.host


class BatchSlot:
    """Lazy handle to one frame of a (possibly not yet decoded) batch."""

    def __init__(self, decoder, layer, job):
        self._decoder = decoder
        self._layer = layer
        self._job = job
        self.gw, self.gh = job.gw, job.gh

    def resolve(self) -> np.ndarray:
        if self._job.out is None:
            self._decoder._flush(self._layer)
        batch, i = self._job.out
        return split_gop_out(batch.fetch()[i], self.gw, self.gh)


def _materialize(result: DecodeResult) -> DecodeResult:
    if hasattr(result.frame, "resolve"):
        result.frame = result.frame.resolve()
    return result


class Decoder:
    """Single-layer AVC decoder whose pixel pipeline runs on ``device``
    (every tensor it makes lives there)."""

    def __init__(self, device="cuda", batch_k: int = BATCH_K,
                 tid_max: int = -1):
        self.device = torch.device(device)
        self.batch_k = max(1, batch_k)
        self.tid_max = tid_max
        self.sps_map: Dict[int, SPS] = {}
        self.pps_map: Dict[int, PPS] = {}
        self._fmo_cache = {}
        self.layer = _Layer()
        self.stats = {"kernel_pictures": 0, "scan_pictures": 0}

    # ------------------------------------------------------------------
    def decode_nal(self, nal_bytes: bytes) -> DecodeResult:
        """Decode one NAL synchronously (frame fetched before return)."""
        r = self.decode_nal_deferred(nal_bytes)
        self.flush_all()
        return _materialize(r)

    def decode_annexb(self, data: bytes, tolerant: bool = True):
        """Decode a whole Annex-B stream, batching pictures.  With
        ``tolerant`` (the reference's behaviour) an undecodable NAL is
        logged and skipped; NotImplementedError always propagates."""
        results = self.enqueue_annexb(data, tolerant)
        self.flush_all()
        return [_materialize(r) for r in results]

    def enqueue_annexb(self, data: bytes, tolerant: bool = True):
        """Parse a whole Annex-B stream and queue its pictures (a batch is
        decoded whenever ``batch_k`` pictures are queued); returns the
        pending results, each frame a ``BatchSlot``."""
        results = []
        for s0, e0 in find_nal_units(data):
            try:
                r = self.decode_nal_deferred(data[s0:e0])
            except NotImplementedError:
                raise
            except Exception as e:                      # noqa: BLE001
                if not tolerant:
                    raise
                log.warn("decoder", "skipping undecodable NAL "
                         "(%d bytes): %s", e0 - s0, e)
                continue
            if r.frame is not None:
                results.append(r)
        return results

    def flush_all(self) -> None:
        self._flush(self.layer)

    def decode_nal_deferred(self, nal_bytes: bytes) -> DecodeResult:
        r = BitReader(strip_emulation_prevention(nal_bytes))
        hdr = N.parse_nal_header(r)
        if hdr.type == N.NAL_SPS:
            sps = SPS.parse(r)
            if sps.seq_parameter_set_id in self.sps_map:
                self._fmo_cache.clear()
            self.sps_map[sps.seq_parameter_set_id] = sps
            return DecodeResult()
        if hdr.type == N.NAL_PPS:
            pps = PPS.parse(r)
            if pps.pic_parameter_set_id in self.pps_map:
                self._fmo_cache.clear()
            self.pps_map[pps.pic_parameter_set_id] = pps
            return DecodeResult()
        if hdr.type in (N.NAL_SUBSET_SPS, N.NAL_PREFIX, N.NAL_SLICE_EXT):
            raise NotImplementedError(
                f"SVC NAL unit type {hdr.type} not ported")
        if hdr.type in (N.NAL_SLICE, N.NAL_SLICE_IDR):
            # plain AVC: non-reference P slices are the disposable
            # (temporal_id > 0) set
            tid = 1 if (hdr.ref_idc == 0 and hdr.type == N.NAL_SLICE) else 0
            if self.tid_max >= 0 and tid > self.tid_max:
                return DecodeResult()
            return self._decode_slice(r, hdr)
        return DecodeResult()

    # ------------------------------------------------------------------
    def _decode_slice(self, r: BitReader, nh: N.NalHeader) -> DecodeResult:
        # pic_parameter_set_id is the 3rd ue(v) of every slice header
        probe = BitReader(r.data)
        probe.pos = r.pos
        probe.ue()                       # first_mb_in_slice
        probe.ue()                       # slice_type
        pps_id = probe.ue()
        pps = self.pps_map.get(pps_id)
        sps = self.sps_map.get(pps.seq_parameter_set_id) if pps else None
        if pps is None or sps is None:
            raise ValueError(f"slice references unknown PPS {pps_id}")
        sh = parse_slice_header(r, sps, pps, nal_ref_idc=nh.ref_idc,
                                is_idr=nh.is_idr)
        gw, gh = sps.pic_width_in_mbs, sps.pic_height_in_mbs
        layer = self.layer
        # picture boundary (7.4.1.2.4 subset): frame_num change, or a slice
        # whose first MB was already decoded
        new_pic = layer.cur is None
        if not new_pic and layer.hdr is not None:
            if sh.frame_num != layer.hdr.frame_num:
                new_pic = True
            else:
                a = sh.first_mb_in_slice
                if layer.cur.slice_id[a // gw, a % gw] >= 0:
                    new_pic = True
        if new_pic:
            layer.cur = SliceData.create(gw, gh)
            layer.hdr = sh
            layer.nal = nh
        sd = layer.cur
        scan_order = None
        if pps.num_slice_groups_minus1 > 0:
            from hartallo_tpu_torch.decode.fmo import (mb_to_slice_group_map,
                                                 slice_scan_order)
            key = (pps.pic_parameter_set_id, sps.seq_parameter_set_id,
                   sh.slice_group_change_cycle)
            sg_map = self._fmo_cache.get(key)
            if sg_map is None:
                sg_map = mb_to_slice_group_map(sps, pps,
                                               sh.slice_group_change_cycle)
                self._fmo_cache[key] = sg_map
            scan_order = slice_scan_order(sg_map, sh.first_mb_in_slice)
        sid = sd._slice_count
        SliceDecoder(sps, pps, sd).decode_slice_data(r, sh,
                                                     scan_order=scan_order)
        sd.wp[sid] = sh.pred_weights
        if (sd.mb_kind >= 0).all():
            frame, poc = self._reconstruct(sps, pps, layer.hdr, layer.nal,
                                           sd, layer)
            layer.cur = None
            return DecodeResult(frame=frame, width=sps.width,
                                height=sps.height, poc=poc)
        return DecodeResult()

    # ------------------------------------------------------------------
    def _reconstruct(self, sps: SPS, pps: PPS, sh: SliceHeader,
                     nh: N.NalHeader, sd: SliceData, layer: _Layer):
        if bool((sd.mb_kind == MB_PCM).any()) or \
                bool((sd.mb_kind == MB_IBL).any()) or \
                effective_weight4x4(sps, pps) is not None or \
                bool(sd.res_pred.any()):
            raise NotImplementedError(GENERAL_PATH)
        return self._enqueue_batched(sps, pps, sh, nh, sd, layer)

    # ------------------------------------------------------------------
    # Batched path
    # ------------------------------------------------------------------
    def _ring_slots(self, sps: SPS) -> int:
        return max(1, sps.max_num_ref_frames) + 1     # last = trash

    def _enqueue_batched(self, sps: SPS, pps: PPS, sh: SliceHeader,
                         nh: N.NalHeader, sd: SliceData, layer: _Layer):
        """Queue one completed picture; flushes at batch_k."""
        gw, gh = sd.gw, sd.gh
        S = self._ring_slots(sps)
        key = (gw, gh, S, pps.chroma_qp_index_offset)
        if layer.ring_key != key:
            self._flush(layer)
            layer.ring_key = key
            layer.ring = None

        has_inter = bool(((sd.mb_kind >= 3) & (sd.mb_kind != MB_IBL)).any())
        if has_inter:
            from hartallo_tpu_torch.decode.mv import derive_mvs
            derive_mvs(sd)
            layer.dpb.max_refs = sps.max_num_ref_frames
            reflist = layer.dpb.ref_list_p(
                sh.frame_num, sps.max_frame_num,
                mods=sh.ref_pic_list_mods_l0,
                num_active=sh.num_ref_idx_l0_active_minus1 + 1)
            if not reflist:
                raise ValueError("P slice without reference frames")
            wp_l, wp_c = self._weight_arrays(sd, len(reflist))
            slot_of = np.array([f.slot for f in reflist], np.int32)
            sd.ref_idx = slot_of[np.clip(sd.ref_idx.astype(np.int64), 0,
                                         len(reflist) - 1)]
        else:
            wp_l = wp_c = None
            sd.ref_idx = np.zeros_like(sd.ref_idx, dtype=np.int32)

        mb_is_inter = (sd.mb_kind >= 3) & (sd.mb_kind != MB_IBL)
        constrained = bool(pps.constrained_intra_pred_flag)
        al, at = availability_masks(sd.slice_id, constrained, mb_is_inter)
        atr = availability_tr(sd.slice_id, constrained, mb_is_inter)
        idc = sd.deblock_idc.astype(np.int32)
        filter_internal = idc != 1
        same_l = np.zeros((gh, gw), bool)
        same_t = np.zeros((gh, gw), bool)
        same_l[:, 1:] = sd.slice_id[:, 1:] == sd.slice_id[:, :-1]
        same_t[1:, :] = sd.slice_id[1:, :] == sd.slice_id[:-1, :]
        has_l = np.zeros((gh, gw), bool)
        has_l[:, 1:] = True
        has_t = np.zeros((gh, gw), bool)
        has_t[1:, :] = True
        fmb_v = filter_internal & has_l & ((idc != 2) | same_l)
        fmb_h = filter_internal & has_t & ((idc != 2) | same_t)

        layer.dpb.max_refs = sps.max_num_ref_frames
        mmco5 = any(m.op == 5 for m in (sh.mmcos or []))
        poc = layer.poc.compute(sps, sh, nh.ref_idc, nh.is_idr, mmco5)
        wslot = S - 1                                      # trash
        if nh.ref_idc != 0:
            fr = Frame(frame_num=sh.frame_num, poc=poc, planes_pad=None,
                       in_ring=True)
            layer.dpb.add(fr, mmcos=sh.mmcos or None, idr=nh.is_idr,
                          long_term_reference_flag=sh
                          .long_term_reference_flag)
            used = {f.slot for f in layer.dpb.frames
                    if f is not fr and f.slot >= 0}
            wslot = next(s for s in range(S - 1) if s not in used)
            fr.slot = wslot

        fast = None
        if d_pool.eligible(sd, wp_l) is None:
            try:
                fast = d_pool.pack_fast(sd, fmb_v, fmb_h, filter_internal,
                                        wslot, pps.chroma_qp_index_offset,
                                        al=al, at=at, atr=atr)
            except OverflowError:
                fast = None
        packed = None if fast is not None else pack_slice_arrays(
            sd, al, at, fmb_v, fmb_h, filter_internal, wp_l=wp_l,
            wp_c=wp_c, atr=atr)
        job = _Job(packed, wslot, bool((~mb_is_inter).any()), gw, gh,
                   fast=fast)
        layer.jobs.append(job)
        if len(layer.jobs) >= self.batch_k:
            self._flush(layer)
        return BatchSlot(self, layer, job), poc

    @staticmethod
    def _weight_arrays(sd: SliceData, n_refs: int):
        """Per-8x8 [w, o, logWD] arrays (8.4.2.3.2) from the per-slice
        pred-weight tables; None when no slice uses explicit weights."""
        if not any(t is not None for t in sd.wp.values()):
            return None, None
        gh, gw = sd.gh, sd.gw
        wp_l = np.zeros((gh, gw, 4, 3), np.int32)
        wp_l[..., 0] = 1
        wp_c = np.zeros((gh, gw, 4, 2, 3), np.int32)
        wp_c[..., 0] = 1
        ref = np.clip(sd.ref_idx.astype(np.int64), 0, n_refs - 1)
        for sid, tab in sd.wp.items():
            if tab is None:
                continue
            mask = sd.slice_id == sid
            r = np.minimum(ref, len(tab.luma_w) - 1)
            m3 = mask[..., None]
            wp_l[..., 0] = np.where(m3, np.asarray(tab.luma_w)[r],
                                    wp_l[..., 0])
            wp_l[..., 1] = np.where(m3, np.asarray(tab.luma_o)[r],
                                    wp_l[..., 1])
            wp_l[..., 2] = np.where(m3, tab.luma_log2_denom, wp_l[..., 2])
            m4 = mask[..., None, None]
            wp_c[..., 0] = np.where(m4, np.asarray(tab.chroma_w)[r],
                                    wp_c[..., 0])
            wp_c[..., 1] = np.where(m4, np.asarray(tab.chroma_o)[r],
                                    wp_c[..., 1])
            wp_c[..., 2] = np.where(m4, tab.chroma_log2_denom,
                                    wp_c[..., 2])
        return wp_l, wp_c

    def _flush(self, layer: _Layer) -> None:
        """Decode all queued pictures: consecutive kernel-eligible pictures
        as one ``decode_gop_fast`` call, the others through the GOP scan,
        in decode order on the one ring."""
        if not layer.jobs:
            return
        jobs, layer.jobs = layer.jobs, []
        gw, gh, S, cqoff = layer.ring_key
        if layer.ring is None:
            layer.ring = tuple(torch.zeros(s, dtype=torch.uint8,
                                           device=self.device)
                               for s in ring_shapes(gw, gh, S))
        ringY, ringU, ringV = layer.ring
        runs = []
        for j in jobs:
            kind = j.fast is not None
            if runs and runs[-1][0] == kind:
                runs[-1][1].append(j)
            else:
                runs.append((kind, [j]))
        for kind, run in runs:
            if kind:
                p = payload_to(stack_payload([j.fast for j in run]),
                               self.device)
                outs, ringY, ringU, ringV = decode_gop_fast(
                    p["smb"], p["aux"], p["sf"], p["tags"], p["vals"],
                    p["ilist"], p["ivals"], ringY, ringU, ringV,
                    gw=gw, gh=gh)
                self.stats["kernel_pictures"] += len(run)
            else:
                outs, ringY, ringU, ringV = decode_gop(
                    np.stack([j.packed for j in run]),
                    [j.wslot for j in run], [j.has_intra for j in run],
                    ringY, ringU, ringV, gw=gw, gh=gh, chroma_qp_off=cqoff)
                self.stats["scan_pictures"] += len(run)
            batch = _BatchOut(outs)
            for i, j in enumerate(run):
                j.out = (batch, i)
        layer.ring = (ringY, ringU, ringV)
