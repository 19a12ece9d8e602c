"""Decoder front end: NAL dispatch -> host slice parse -> pixel pipeline on
the decoder's device -> output frames.

Port of ``hartallo_tpu/decode/decoder.py``.  The host parse (``native``
CAVLC, ``mv``, ``dpb``, ``poc``, ``fmo``, the parameter sets, slice
headers and the SVC motion inference ``svc/motion.py``) is the port's
copy of the JAX package's host modules.  Each picture takes one of two
routes:

- the batched route: completed pictures are queued and decoded a batch
  at a time, with the DPB held on the device as a ring of half-pel
  reference stacks.  A picture ``d_pool.eligible`` accepts (the rule is
  the JAX package's) goes to ``d_gop_fast.decode_gop_fast``: the CUDA
  kernel on a CUDA device, its plain torch twin on the CPU; any other to
  the GOP scan ``d_gop.decode_gop``, as in the JAX package (for example
  a P picture with explicit weighted prediction), whose int16 rows are
  packed straight into a host buffer, page-locked on a CUDA device, and
  reach the device through one asynchronous copy a batch
  (``decode/staging.py``; plain memory on the CPU).  Unlike the JAX
  package, the kernel takes a picture with any number of intra MBs or
  residual blocks (every 720p and 1080p IDR picture, which the Pallas
  kernel's capacities send to the scan);
- the general route, per picture: I_PCM, SVC I_BL (inter-layer intra),
  non-flat scaling lists, SVC residual prediction and quality refinement.
  ``d_device.decode_frame_pre`` decodes the residual and predicts the
  inter and I_BL MBs, the intra wavefront follows when the picture holds
  an Intra4x4 or Intra16x16 MB (without one it would leave the planes as
  they are; ``decode/intra_recon_fast.intra_reconstruct_fast``), and the
  frame deblock is the deblock parameters
  (``ops/deblock_fast.deblock_params_dec_fast``) and the filter
  (``deblock_frame_aux_fast``), each a CUDA kernel on a CUDA device (the
  JAX package runs XLA here), its plain twin on the CPU.

The two routes share each layer's ring: a reference picture of the
general route gets a ring slot and is uploaded into the ring (as its
half-pel stack, ``encode/p_body_fast.halfpel_planes_fast``) before the
next batch that predicts from it.

Multi-layer (SVC) aware: per-DQId layer contexts with their own DPBs,
POC state and rings, output windows ``dqid_min`` / ``dqid_max`` and
``tid_max``, inter-layer motion inference for base-mode macroblocks,
I_BL from the 16-phase upsampled base reconstruction, residual
prediction from the base layer's residual and quality refinement by
transform-coefficient accumulation.

``stats`` counts the pictures of each route.  In tolerant mode (the
default) an undecodable NAL unit is logged and skipped, as in the JAX
package and the reference (for example an MVC slice extension, which
``nal.parse_nal_header`` rejects).

Spans and counters (``hartallo_tpu_torch.tracing``).  A decode call on
the batched route runs as these spans, one after another and none
inside another: under ``torch.profiler`` each is a ``record_function``
range, after ``tracing.enable()`` each adds its count and duration to
``tracing.snapshot()["spans"]``, and otherwise each costs a fraction of
a microsecond.

- ``decode.nal``: ``find_nal_units``, and per NAL the emulation-
  prevention strip, the NAL header, the parameter sets and the PPS probe
  of a slice, up to its slice header;
- ``decode.parse``: the calls of ``parse_slice_header`` and
  ``SliceDecoder.decode_slice_data`` (the native CAVLC parse), nothing
  else;
- ``decode.prepare``: the decoder's own work between those calls and the
  enqueue's: picture boundary, ``SliceData.create``, FMO order,
  completeness, route choice (``_reconstruct``, ``d_pool.eligible``),
  reference list and ring slots, weight arrays, availability and filter
  masks, POC, DPB, the queued job;
- ``decode.enqueue``: the calls of ``mv.derive_mvs``, ``d_pool.pack_fast``
  and ``pack_slice_rows`` with its staging row, nothing else;
- ``decode.upload``: a batch's payload made and handed to the device
  (``stack_payload`` and ``payload_to``, or ``RowStaging.upload``);
- ``decode.launch``: the rest of ``_flush``: the ring, the general-route
  references synced into it, ``decode_gop_fast`` / ``decode_gop``, the
  output's bookkeeping;
- ``decode.fetch``: a batch's frames copied to the host
  (``_BatchOut.fetch``; a general-route frame's in
  ``_PlanesFrame.resolve``);
- ``decode.output``: one frame cut out of its batch (``split_gop_out``).

A flush that ``batch_k`` queued pictures start runs after the
picture's enqueue spans have closed.  The general route, the encoder and
``parallel/shard.py`` have no spans of their own.  Counters
(``tracing.add``, always on):

- ``decode.batches``: batch runs that ``_flush`` launched (consecutive
  pictures of one route);
- ``decode.upload_bytes``: the bytes of each batch's payload or scan
  rows handed to the device (the kernels' constant tables, a few KB a
  launch, are not counted);
- ``decode.fetch_bytes``: the bytes of output frames copied to the host
  (a whole batch at a time);
- ``decode.pack_native``: kernel-route pictures whose payload
  ``d_pool.pack_fast`` built in its native pass (``native/packc.c``).

On a CPU decoder the same bytes are counted, though nothing is copied.

Reference parity: ``hl_codec_264.c:79-397`` (_decode),
``hl_codec_264_nal.c`` (slice pipeline), ``hl_codec_264_decode_avc.c``
(per-picture order), ``hl_codec_264_decode_svc.c`` (Annex-G layer
decode).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from hartallo_tpu_torch import tracing
from hartallo_tpu_torch.api import DecodeResult
from hartallo_tpu_torch.bitio import BitReader, find_nal_units, \
    strip_emulation_prevention
from hartallo_tpu_torch.decode import nal as N
from hartallo_tpu_torch.decode.dpb import DPB, Frame
from hartallo_tpu_torch.decode.params import (PPS, SPS, effective_weight4x4,
                                              parse_subset_sps)
from hartallo_tpu_torch.decode.poc import PocDecoder
from hartallo_tpu_torch.decode.slice_decode import (MB_I16, MB_I4X4, MB_IBL,
                                                    MB_PBL, MB_PCM,
                                                    SliceData, SliceDecoder)
from hartallo_tpu_torch.decode.sliceheader import SliceHeader, \
    parse_slice_header
from hartallo_tpu_torch.util import log
from hartallo_tpu_torch.decode import d_pool
from hartallo_tpu_torch.decode.d_fused import pack_slice_rows
from hartallo_tpu_torch.decode.d_gop import (WORDS, decode_gop, ring_shapes,
                                             split_gop_out)
from hartallo_tpu_torch.decode.d_gop_fast import (decode_gop_fast,
                                                  payload_to, stack_payload)
from hartallo_tpu_torch.decode.intra_recon import (PAD, availability_masks,
                                                   availability_tr)
from hartallo_tpu_torch.decode.intra_recon_fast import intra_reconstruct_fast
from hartallo_tpu_torch.decode.staging import RowStaging
from hartallo_tpu_torch.encode.p_body_fast import halfpel_planes_fast
from hartallo_tpu_torch.ops.deblock_fast import (RECORD_OFFSETS,
                                                 deblock_frame_aux_fast,
                                                 deblock_params_dec_fast,
                                                 pack_deblock_record)

BATCH_K = 16     # pictures per batch


class _Layer:
    def __init__(self):
        self.cur: Optional[SliceData] = None
        self.hdr: Optional[SliceHeader] = None
        self.nal: Optional[N.NalHeader] = None
        self.dpb = DPB()
        self.poc = PocDecoder()
        self.last_recon = None           # _Job, or (y, u, v) tensors
        self.last_motion = None          # (mv, ref_idx, intra, gw, gh)
        self.last_residual = None        # (rY, rCb, rCr) rS arrays
        self.last_coeffs = None          # quantized levels + qp (G.8.5.1)
        # batched-route state
        self.ring = None                 # (ringY, ringU, ringV) tensors
        self.ring_key = None             # (gw, gh, S, chroma_qp_off)
        self.jobs = []                   # queued _Job records
        self.pending_sync = []           # Frames to upload into the ring
        self.staging = None              # staging.RowStaging of scan rows


class _Job:
    __slots__ = ("packed", "wslot", "has_intra", "out", "gw", "gh", "fast")

    def __init__(self, packed, wslot, has_intra, gw, gh, fast=None):
        self.packed = packed             # its rows in the batch's staging
        #                                  buffer (scan route) or None
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
            with tracing.span("decode.fetch"):
                self.host = self.dev.cpu().numpy()
                tracing.add("decode.fetch_bytes", self.host.nbytes)
            self.dev = None
        return self.host


class BatchSlot:
    """Lazy handle to one frame of a (possibly not yet decoded) batch."""

    def __init__(self, decoder, layer, job):
        self._decoder = decoder
        self._layer = layer
        self._job = job
        self.gw, self.gh = job.gw, job.gh

    def _row(self):
        if self._job.out is None:
            self._decoder._flush(self._layer)
        return self._job.out

    def resolve(self) -> np.ndarray:
        batch, i = self._row()
        host = batch.fetch()
        with tracing.span("decode.output"):
            return split_gop_out(host[i], self.gw, self.gh)


class _PlanesFrame:
    """A general-route picture's output planes on the device; fetched as
    packed I420 when the result is materialized."""
    __slots__ = ("planes",)

    def __init__(self, planes):
        self.planes = planes

    def resolve(self) -> np.ndarray:
        with tracing.span("decode.fetch"):
            host = torch.cat([p.reshape(-1) for p in self.planes]).cpu() \
                .numpy()
            tracing.add("decode.fetch_bytes", host.nbytes)
        return host


def _materialize(result: DecodeResult) -> DecodeResult:
    if hasattr(result.frame, "resolve"):
        result.frame = result.frame.resolve()
    return result


def _ref_layer_dqid(sh: SliceHeader, dqid: int) -> int:
    """The DQId of the inter-layer reference: ref_layer_dq_id when the
    slice header carries it, else the next lower quality or dependency
    layer."""
    if sh.ref_layer_dq_id >= 0:
        return sh.ref_layer_dq_id
    return dqid - 1 if (dqid & 15) else dqid - 16


class Decoder:
    """Decoder whose pixel pipeline runs on ``device`` (every tensor it
    makes lives there)."""

    # every batched picture takes the dense buffer (``_Job.packed``) and
    # none the kernel's payload: set by the sharded decoder of
    # ``parallel/shard.py``, whose flush reads only the dense buffer
    dense_packed = False

    def __init__(self, device="cuda", batch_k: int = BATCH_K,
                 tid_max: int = -1, dqid_min: int = -1, dqid_max: int = -1):
        self.device = torch.device(device)
        self.batch_k = max(1, batch_k)
        self.tid_max = tid_max
        self.dqid_min = dqid_min
        self.dqid_max = dqid_max
        self.sps_map: Dict[int, SPS] = {}
        self.pps_map: Dict[int, PPS] = {}
        self._prefix_svc = None          # SVC ext of the pending prefix NAL
        self._fmo_cache = {}
        self._svc_seen = False           # stream carries SVC ext NALs
        self.layers: Dict[int, _Layer] = {}
        self.stats = {"kernel_pictures": 0, "scan_pictures": 0,
                      "general_pictures": 0}

    def _layer(self, dqid: int) -> _Layer:
        if dqid not in self.layers:
            self.layers[dqid] = _Layer()
        return self.layers[dqid]

    @property
    def layer(self) -> _Layer:
        """The base layer's context (DQId 0)."""
        return self._layer(0)

    # ------------------------------------------------------------------
    def decode_nal(self, nal_bytes: bytes) -> DecodeResult:
        """Decode one NAL synchronously (frame fetched before return)."""
        r = self.decode_nal_deferred(nal_bytes)
        self.flush_all()
        return _materialize(r)

    def decode_annexb(self, data: bytes, tolerant: bool = True):
        """Decode a whole Annex-B stream, batching pictures.  With
        ``tolerant`` (the reference's behaviour) an undecodable NAL is
        logged and skipped."""
        results = self.enqueue_annexb(data, tolerant)
        self.flush_all()
        return [_materialize(r) for r in results]

    def enqueue_annexb(self, data: bytes, tolerant: bool = True):
        """Parse a whole Annex-B stream and queue its pictures (a batch is
        decoded whenever ``batch_k`` pictures of a layer are queued);
        returns the pending results, each frame a lazy handle."""
        results = []
        with tracing.span("decode.nal"):
            units = find_nal_units(data)
        for s0, e0 in units:
            try:
                r = self.decode_nal_deferred(data[s0:e0])
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
        for layer in self.layers.values():
            self._flush(layer)

    def decode_nal_deferred(self, nal_bytes: bytes) -> DecodeResult:
        with tracing.span("decode.nal"):
            r = BitReader(strip_emulation_prevention(nal_bytes))
            hdr = N.parse_nal_header(r)
            params = self._take_nal(r, hdr)
        if params is None:
            return DecodeResult()
        return self._decode_slice(r, hdr, *params)

    def _take_nal(self, r: BitReader, hdr: N.NalHeader):
        """Keep a parameter set, or a prefix NAL's SVC extension; drop a
        slice above ``tid_max``.  For a slice to decode, return its (sps,
        pps); else None."""
        if hdr.type == N.NAL_SPS:
            sps = SPS.parse(r)
            if sps.seq_parameter_set_id in self.sps_map:
                self._fmo_cache.clear()
            self.sps_map[sps.seq_parameter_set_id] = sps
            return None
        if hdr.type == N.NAL_SUBSET_SPS:
            self._svc_seen = True
            sps = parse_subset_sps(r)
            self.sps_map[sps.seq_parameter_set_id] = sps
            return None
        if hdr.type == N.NAL_PPS:
            pps = PPS.parse(r)
            if pps.pic_parameter_set_id in self.pps_map:
                self._fmo_cache.clear()
            self.pps_map[pps.pic_parameter_set_id] = pps
            return None
        if hdr.type == N.NAL_PREFIX:
            # prefix NAL of the following base-layer slice: its SVC
            # extension header carries the temporal_id
            self._prefix_svc = hdr.svc
            return None
        if hdr.type not in (N.NAL_SLICE, N.NAL_SLICE_IDR, N.NAL_SLICE_EXT):
            return None
        svc = hdr.svc if hdr.type == N.NAL_SLICE_EXT else self._prefix_svc
        self._prefix_svc = None
        if svc is not None:
            tid = svc.temporal_id
        else:
            # plain AVC: non-reference P slices are the disposable
            # (temporal_id > 0) set
            tid = 1 if (hdr.ref_idc == 0 and hdr.type == N.NAL_SLICE) else 0
        if self.tid_max >= 0 and tid > self.tid_max:
            return None                  # droppable temporal layer
        if hdr.type == N.NAL_SLICE_EXT:
            self._svc_seen = True
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
        return sps, pps

    # ------------------------------------------------------------------
    def _decode_slice(self, r: BitReader, nh: N.NalHeader, sps: SPS,
                      pps: PPS) -> DecodeResult:
        svc_ext = nh.type == N.NAL_SLICE_EXT
        dqid = nh.svc.dqid if (svc_ext and nh.svc) else 0
        no_ilp = nh.svc.no_inter_layer_pred_flag if (svc_ext and nh.svc) \
            else 1
        quality_id = nh.svc.quality_id if (svc_ext and nh.svc) else 0
        with tracing.span("decode.parse"):
            sh = parse_slice_header(
                r, sps, pps, nal_ref_idc=nh.ref_idc, is_idr=nh.is_idr,
                svc_ext=svc_ext, no_inter_layer_pred=bool(no_ilp),
                quality_id=quality_id)
        with tracing.span("decode.prepare"):
            gw, gh = sps.pic_width_in_mbs, sps.pic_height_in_mbs
            layer = self._layer(dqid)
            # picture boundary (7.4.1.2.4 subset): frame_num change, or a
            # slice whose first MB was already decoded (FMO slice groups
            # need not contain MB 0, so first_mb == 0 alone is not a
            # boundary)
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
            svc_il = svc_ext and not no_ilp
            scan_order = None
            if pps.num_slice_groups_minus1 > 0:
                # FMO: non-raster MB visit order per the slice-group map
                # (8.2.2), identical for every slice of the picture: cached
                from hartallo_tpu_torch.decode.fmo import (
                    mb_to_slice_group_map, slice_scan_order)
                key = (pps.pic_parameter_set_id, sps.seq_parameter_set_id,
                       sh.slice_group_change_cycle)
                sg_map = self._fmo_cache.get(key)
                if sg_map is None:
                    sg_map = mb_to_slice_group_map(
                        sps, pps, sh.slice_group_change_cycle)
                    self._fmo_cache[key] = sg_map
                scan_order = slice_scan_order(sg_map, sh.first_mb_in_slice)
            sid = sd._slice_count
            slice_decoder = SliceDecoder(sps, pps, sd)
        with tracing.span("decode.parse"):
            slice_decoder.decode_slice_data(
                r, sh, svc_inter_layer=svc_il, scan_order=scan_order)
        with tracing.span("decode.prepare"):
            sd.wp[sid] = sh.pred_weights
            if not (sd.mb_kind >= 0).all():
                return DecodeResult()
            if svc_il and (bool((sd.mb_kind == MB_PBL).any()) or
                           bool(sd.motion_pred_l0.any())):
                self._infer_inter_layer_motion(sd, sps, layer.hdr, dqid)
        frame, poc = self._reconstruct(sps, pps, layer.hdr, layer.nal, sd,
                                       layer, dqid)
        with tracing.span("decode.prepare"):
            # per-picture motion state for a following enhancement
            # layer's G.8.6.1 inference (base_mode_flag)
            layer.last_motion = (
                sd.mv, getattr(sd, "ref_idx_list", sd.ref_idx),
                (sd.mb_kind <= 2) | (sd.mb_kind == MB_IBL),
                sd.gw, sd.gh)
            if self._svc_seen:
                # rS arrays for a following layer's G.8.6.3 residual
                # prediction (inter MBs only; intra re-initialised), and
                # the quantized levels for a following quality layer's
                # G.8.5.1 refinement (sTCoeff accumulation)
                layer.last_residual = d_pool.residual_planes_np(
                    sd, pps.chroma_qp_index_offset)
                layer.last_coeffs = (sd.luma_ac.copy(),
                                     sd.chroma_ac.copy(),
                                     sd.chroma_dc.copy(), sd.qp.copy())
            layer.cur = None
            if self.dqid_min >= 0 and dqid < self.dqid_min:
                return DecodeResult()
            if self.dqid_max >= 0 and dqid > self.dqid_max:
                return DecodeResult()
            return DecodeResult(frame=frame, width=sps.width,
                                height=sps.height, dqid=dqid, poc=poc)

    # ------------------------------------------------------------------
    def _infer_inter_layer_motion(self, sd: SliceData, sps: SPS,
                                  sh: SliceHeader, dqid: int) -> None:
        """G.8.6.1 motion inference for base_mode_flag=1 EP macroblocks
        (and inter-layer MV predictors for motion_prediction_flag_l0):
        fills sd.mv/sd.ref_idx of MB_PBL macroblocks from the reference
        layer's decoded motion, and turns MBs whose co-located reference
        MB is intra into MB_IBL (the intraILPredFlag branch).

        Reference: hl_codec_264_utils.c:1674-2006 (G.8.6.1.1/.2) and
        :1498-1671 (G.8.4.1 SVC); RSRC index mapping for dyadic and
        same-resolution layer pairs, the full ESS derivation (G.6.1
        position mapping + G-210..G-261) for any other ratio."""
        from hartallo_tpu_torch.svc.motion import infer_motion
        base = self.layers.get(_ref_layer_dqid(sh, dqid))
        if base is None or base.last_motion is None:
            raise ValueError("base_mode_flag without decoded base layer")
        bmv, bref, bintra, bgw, bgh = base.last_motion
        mv_il, ref_il, ibl = infer_motion(bmv, bref, bintra, sd.gw, sd.gh)
        pbl = sd.mb_kind == MB_PBL
        sd.mb_kind[pbl & ibl] = MB_IBL
        take = pbl & ~ibl
        sd.mv[take] = mv_il[take]
        sd.ref_idx[take] = ref_il[take].astype(sd.ref_idx.dtype)
        # inter-layer predictors for motion_prediction_flag partitions
        sd._il_mv = mv_il
        sd._il_ref = ref_il

    # ------------------------------------------------------------------
    def _reconstruct(self, sps: SPS, pps: PPS, sh: SliceHeader,
                     nh: N.NalHeader, sd: SliceData, layer: _Layer,
                     dqid: int):
        with tracing.span("decode.prepare"):
            has_pcm = bool((sd.mb_kind == MB_PCM).any())
            has_ibl = bool((sd.mb_kind == MB_IBL).any())
            nonflat = effective_weight4x4(sps, pps) is not None
            has_respred = bool(sd.res_pred.any())
            qref = (dqid & 15) > 0 and \
                bool(((sd.mb_kind >= 3) & (sd.mb_kind != MB_IBL)).any())
            batched = not (has_pcm or has_ibl or nonflat or has_respred or
                           qref)
        if batched:
            return self._enqueue_batched(sps, pps, sh, nh, sd, layer)
        return self._reconstruct_general(sps, pps, sh, nh, sd, layer, dqid)

    # ------------------------------------------------------------------
    # Batched route
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
        with tracing.span("decode.prepare"):
            # frames decoded before the ring existed need slots
            for f in layer.dpb.frames:
                if f.slot < 0:
                    used = {g.slot for g in layer.dpb.frames if g.slot >= 0}
                    f.slot = next(s for s in range(S - 1) if s not in used)
            mb_is_inter = (sd.mb_kind >= 3) & (sd.mb_kind != MB_IBL)
            has_inter = bool(mb_is_inter.any())
        if has_inter:
            from hartallo_tpu_torch.decode.mv import derive_mvs
            with tracing.span("decode.enqueue"):
                derive_mvs(sd)
        with tracing.span("decode.prepare"):
            if has_inter:
                wp_l, wp_c = self._reference_slots(sps, sh, sd, layer)
            else:
                wp_l = wp_c = None
                sd.ref_idx = np.zeros_like(sd.ref_idx, dtype=np.int32)
            constrained = bool(pps.constrained_intra_pred_flag)
            al, at = availability_masks(sd.slice_id, constrained,
                                        mb_is_inter)
            atr = availability_tr(sd.slice_id, constrained, mb_is_inter)
            fmb_v, fmb_h, filter_internal = self._filter_flags(sd)

            layer.dpb.max_refs = sps.max_num_ref_frames
            mmco5 = any(m.op == 5 for m in (sh.mmcos or []))
            poc = layer.poc.compute(sps, sh, nh.ref_idc, nh.is_idr, mmco5)
            wslot = S - 1                                  # trash
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
            kernel = not self.dense_packed and \
                d_pool.eligible(sd, wp_l) is None

        fast = None
        with tracing.span("decode.enqueue"):
            if kernel:
                try:
                    fast = d_pool.pack_fast(
                        sd, fmb_v, fmb_h, filter_internal, wslot,
                        pps.chroma_qp_index_offset, al=al, at=at, atr=atr)
                except OverflowError:
                    fast = None
            packed = None if fast is not None else pack_slice_rows(
                sd, al, at, fmb_v, fmb_h, filter_internal, wp_l=wp_l,
                wp_c=wp_c, atr=atr, out=self._staging(layer).row(
                    len(layer.jobs), (gh * gw, WORDS)))
        with tracing.span("decode.prepare"):
            job = _Job(packed, wslot, bool((~mb_is_inter).any()), gw, gh,
                       fast=fast)
            layer.jobs.append(job)
            # the job, not its BatchSlot: a slot holds the decoder, and a
            # layer holding a slot would keep the decoder and its rings on
            # the device alive until the cyclic garbage collector ran
            layer.last_recon = job
        if len(layer.jobs) >= self.batch_k:
            self._flush(layer)
        return BatchSlot(self, layer, job), poc

    def _reference_slots(self, sps: SPS, sh: SliceHeader, sd: SliceData,
                         layer: _Layer):
        """A P picture's reference list: its refIdx turned into ring slots
        (the list's view kept as ``sd.ref_idx_list``), general-route
        references queued for the ring; returns its weight arrays."""
        layer.dpb.max_refs = sps.max_num_ref_frames
        reflist = layer.dpb.ref_list_p(
            sh.frame_num, sps.max_frame_num,
            mods=sh.ref_pic_list_mods_l0,
            num_active=sh.num_ref_idx_l0_active_minus1 + 1)
        if not reflist:
            raise ValueError("P slice without reference frames")
        for f in reflist:
            # frames of the general route go into the ring before this
            # batch runs (they may leave the DPB before the flush:
            # recorded now)
            if not f.in_ring and f.planes_pad is not None:
                layer.pending_sync.append(f)
                f.in_ring = True
        wp_l, wp_c = self._weight_arrays(sd, len(reflist))
        slot_of = np.array([f.slot for f in reflist], np.int32)
        # the list-index view, for a following layer's G.8.6.1
        # inference (the slots below are ring-local)
        sd.ref_idx_list = sd.ref_idx.copy()
        sd.ref_idx = slot_of[np.clip(sd.ref_idx.astype(np.int64), 0,
                                     len(reflist) - 1)]
        return wp_l, wp_c

    @staticmethod
    def _filter_flags(sd: SliceData):
        """(fmb_v, fmb_h, filter_internal) (gh, gw) bool: the MB-edge and
        internal-edge deblock flags of disable_deblocking_filter_idc."""
        gw, gh = sd.gw, sd.gh
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
        return fmb_v, fmb_h, filter_internal

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
        """Decode all queued pictures of a layer: first upload the
        general-route reference frames they predict from into the ring,
        then decode consecutive kernel-eligible pictures as one
        ``decode_gop_fast`` call and the others through the GOP scan, in
        decode order on the one ring."""
        if not layer.jobs:
            return
        with tracing.span("decode.launch"):
            jobs, layer.jobs = layer.jobs, []
            staging, layer.staging = layer.staging, None
            gw, gh, S, cqoff = layer.ring_key
            if layer.ring is None:
                layer.ring = tuple(torch.zeros(s, dtype=torch.uint8,
                                               device=self.device)
                                   for s in ring_shapes(gw, gh, S))
            ringY, ringU, ringV = layer.ring
            sync, layer.pending_sync = layer.pending_sync, []
            for f in sync:
                if f.slot >= 0 and f.planes_pad is not None:
                    hp = halfpel_planes_fast(f.planes_pad[0])
                    ringY[f.slot].zero_()
                    ringY[f.slot, :, :hp.shape[1], :hp.shape[2]] = \
                        hp.to(torch.uint8)
                    for ring, p in ((ringU, f.planes_pad[1]),
                                    (ringV, f.planes_pad[2])):
                        ring[f.slot].zero_()
                        ring[f.slot, :p.shape[0], :p.shape[1]] = \
                            p.to(torch.uint8)
            runs = []                   # (kernel route, jobs, first index)
            for i, j in enumerate(jobs):
                kind = j.fast is not None
                if runs and runs[-1][0] == kind:
                    runs[-1][1].append(j)
                else:
                    runs.append((kind, [j], i))
        for kind, run, i0 in runs:
            with tracing.span("decode.upload"):
                if kind:
                    payload = stack_payload([j.fast for j in run])
                    tracing.add("decode.upload_bytes",
                                sum(a.nbytes for a in payload.values()))
                    p = payload_to(payload, self.device)
                else:
                    rows = staging.rows(i0, i0 + len(run))
                    tracing.add("decode.upload_bytes", rows.nbytes)
                    rows = staging.upload(rows)
            with tracing.span("decode.launch"):
                if kind:
                    outs, ringY, ringU, ringV = decode_gop_fast(
                        p["smb"], p["aux"], p["sf"], p["tags"], p["vals"],
                        p["ilist"], p["ivals"], ringY, ringU, ringV,
                        gw=gw, gh=gh)
                    self.stats["kernel_pictures"] += len(run)
                else:
                    outs, ringY, ringU, ringV = decode_gop(
                        rows, [j.wslot for j in run],
                        [j.has_intra for j in run], ringY, ringU, ringV,
                        gw=gw, gh=gh, chroma_qp_off=cqoff)
                    self.stats["scan_pictures"] += len(run)
                tracing.add("decode.batches")
                batch = _BatchOut(outs)
                for i, j in enumerate(run):
                    j.out = (batch, i)
        layer.ring = (ringY, ringU, ringV)

    def _staging(self, layer: _Layer) -> RowStaging:
        """The host buffer of the layer's queued scan rows (made at the
        batch's first, a batch's worth of rows)."""
        if layer.staging is None:
            layer.staging = RowStaging(self.device, min(self.batch_k, 8))
        return layer.staging

    def _materialize_ring_frames(self, layer: _Layer) -> None:
        """Give every in-ring DPB frame its own padded planes (for the
        general route)."""
        if layer.ring is None:
            return
        self._flush(layer)
        ringY, ringU, ringV = layer.ring
        gw, gh = layer.ring_key[0], layer.ring_key[1]
        Hp, Wp = gh * 16 + 2 * PAD, gw * 16 + 2 * PAD
        Hcp, Wcp = gh * 8 + 2 * PAD, gw * 8 + 2 * PAD
        for f in layer.dpb.frames:
            if f.in_ring and f.planes_pad is None and f.slot >= 0:
                f.planes_pad = (
                    ringY[f.slot, 0, :Hp, :Wp].to(torch.int32),
                    ringU[f.slot, :Hcp, :Wcp].to(torch.int32),
                    ringV[f.slot, :Hcp, :Wcp].to(torch.int32))

    # ------------------------------------------------------------------
    # General route (I_PCM, SVC I_BL, scaling lists, residual prediction,
    # quality refinement)
    # ------------------------------------------------------------------
    def _tensor(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

    def _base_planes(self, base: _Layer):
        """The base layer's last reconstruction as (y, u, v) planes at its
        coded size on the decoder's device, without a trip to the host
        while a batched picture's output is still there."""
        job = base.last_recon
        if not isinstance(job, _Job):
            return job
        if job.out is None:
            self._flush(base)
        batch, i = job.out
        row = batch.dev[i] if batch.dev is not None else \
            torch.as_tensor(batch.host[i], device=self.device)
        H, W = job.gh * 16, job.gw * 16
        uv = row[H:].reshape(H // 2, 2, W // 2)
        return row[:H], uv[:, 0], uv[:, 1]

    def _reconstruct_general(self, sps: SPS, pps: PPS, sh: SliceHeader,
                             nh: N.NalHeader, sd: SliceData, layer: _Layer,
                             dqid: int):
        from hartallo_tpu_torch.decode.d_device import (crop_to_host,
                                                        decode_frame_pre,
                                                        edge_pad_device)
        self._flush(layer)
        self._materialize_ring_frames(layer)
        self.stats["general_pictures"] += 1
        gw, gh = sd.gw, sd.gh
        W, H = gw * 16, gh * 16
        dev = self.device

        inter_mask = (sd.mb_kind >= 3) & (sd.mb_kind != MB_IBL)
        has_inter = bool(inter_mask.any())
        has_ibl = bool((sd.mb_kind == MB_IBL).any())

        ry = ru = rv = torch.zeros((1, 1, 1), dtype=torch.int32, device=dev)
        if has_inter:
            from hartallo_tpu_torch.decode.mv import derive_mvs
            with tracing.span("decode.enqueue"):
                derive_mvs(sd)
            layer.dpb.max_refs = sps.max_num_ref_frames
            reflist = layer.dpb.ref_list_p(
                sh.frame_num, sps.max_frame_num,
                mods=sh.ref_pic_list_mods_l0,
                num_active=sh.num_ref_idx_l0_active_minus1 + 1)
            if not reflist:
                raise ValueError("P slice without reference frames")
            ry, ru, rv = (torch.stack([f.planes_pad[c] for f in reflist])
                          for c in range(3))

        up_y_mb = torch.zeros((gh, gw, 16, 16), dtype=torch.int32,
                              device=dev)
        up_c_mb = torch.zeros((gh, gw, 2, 8, 8), dtype=torch.int32,
                              device=dev)
        if has_ibl:
            from hartallo_tpu_torch.svc.upsample import upsample_plane
            base = self.layers.get(_ref_layer_dqid(sh, dqid))
            if base is None or base.last_recon is None:
                raise ValueError("I_BL without decoded base layer")
            by, bu, bv = self._base_planes(base)
            up_y = upsample_plane(by, H, W)
            up_u = upsample_plane(bu, H // 2, W // 2, chroma=True)
            up_v = upsample_plane(bv, H // 2, W // 2, chroma=True)
            up_y_mb = up_y.reshape(gh, 16, gw, 16).permute(0, 2, 1, 3)
            up_c_mb = torch.stack(
                [p.reshape(gh, 8, gw, 8).permute(0, 2, 1, 3)
                 for p in (up_u, up_v)], dim=2)

        # I_PCM planes (rare): composed on the host once
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

        # SVC inter-layer residual prediction (G.8.6.3): rS of the
        # reference layer, added under clip3 before reconstruction
        has_respred = bool(sd.res_pred.any())
        res_add_y = np.zeros((H, W), np.int32)
        res_add_c = np.zeros((2, H // 2, W // 2), np.int32)
        rp_mask_np = sd.res_pred != 0
        luma_ac, luma_dc = sd.luma_ac, sd.luma_dc
        chroma_ac, chroma_dc = sd.chroma_ac, sd.chroma_dc
        if (dqid & 15) > 0 and has_inter:
            # quality refinement (G.8.5.1): this picture's transform-
            # coefficient levels accumulate with the quality-base
            # picture's BEFORE the inverse transform; the combined
            # residual rides the respred accumulation input, and the
            # current picture's coefficients are zeroed so that its own
            # residual contribution is exactly the accumulation
            base_dqid = sh.ref_layer_dq_id if sh.ref_layer_dq_id >= 0 \
                else dqid - 1
            base = self.layers.get(base_dqid)
            if base is None or base.last_coeffs is None:
                raise ValueError("quality refinement without decoded "
                                 "quality-base coefficients")
            res_add_y, res_add_c0, res_add_c1 = \
                d_pool.accumulated_residual_planes_np(
                    base.last_coeffs,
                    (sd.luma_ac, sd.chroma_ac, sd.chroma_dc, sd.qp),
                    pps.chroma_qp_index_offset)
            res_add_c = np.stack([res_add_c0, res_add_c1])
            rp_mask_np = inter_mask
            luma_ac = np.zeros_like(sd.luma_ac)
            luma_dc = np.zeros_like(sd.luma_dc)
            chroma_ac = np.zeros_like(sd.chroma_ac)
            chroma_dc = np.zeros_like(sd.chroma_dc)
            has_respred = True
        elif has_respred:
            base = self.layers.get(_ref_layer_dqid(sh, dqid))
            if base is None or base.last_residual is None:
                raise ValueError("residual_prediction without decoded "
                                 "base-layer residual")
            bry, brcb, brcr = base.last_residual
            if bry.shape != (H, W):
                # spatial layers: G.8.6.3 residual resampling
                from hartallo_tpu_torch.svc.upsample import \
                    upsample_residual_plane_np
                bry = upsample_residual_plane_np(bry, H, W)
                brcb = upsample_residual_plane_np(brcb, H // 2, W // 2,
                                                  chroma=True)
                brcr = upsample_residual_plane_np(brcr, H // 2, W // 2,
                                                  chroma=True)
            res_add_y = bry
            res_add_c = np.stack([brcb, brcr])

        w4 = effective_weight4x4(sps, pps)
        t = self._tensor
        padY, padU, padV, res_y, res_c = decode_frame_pre(
            t(luma_ac), t(luma_dc), t(chroma_ac), t(chroma_dc), t(sd.qp),
            t(sd.mb_kind == MB_I16, torch.bool), t(sd.mv), t(sd.ref_idx),
            ry, ru, rv, up_y_mb, up_c_mb, t(sd.mb_kind), t(pcm_y), t(pcm_u),
            t(pcm_v), t(w4 if w4 is not None
                        else np.full((2, 3, 4, 4), 16, np.int32)),
            t(res_add_y), t(res_add_c), t(rp_mask_np, torch.bool),
            gw=gw, gh=gh, has_inter=has_inter, has_ibl=has_ibl,
            chroma_qp_off=pps.chroma_qp_index_offset,
            use_weights=w4 is not None, has_respred=has_respred)

        kind = np.where(sd.mb_kind == MB_I4X4, 0,
                        np.where(sd.mb_kind == MB_I16, 1, 2))
        if (kind < 2).any():
            al, at = availability_masks(
                sd.slice_id, bool(pps.constrained_intra_pred_flag),
                inter_mask)
            atr = availability_tr(
                sd.slice_id, bool(pps.constrained_intra_pred_flag),
                inter_mask)
            padY, padU, padV = intra_reconstruct_fast(
                (padY, padU, padV), res_y, res_c, t(kind), t(sd.i16_mode),
                t(sd.i4_modes), t(sd.chroma_mode), t(al, torch.bool),
                t(at, torch.bool), t(atr, torch.bool), gw=gw, gh=gh)

        if (sd.deblock_idc != 1).any():
            padY, padU, padV = self._deblock(pps, sd, (padY, padU, padV))

        planes = (crop_to_host(padY), crop_to_host(padU),
                  crop_to_host(padV))
        layer.last_recon = planes

        layer.dpb.max_refs = sps.max_num_ref_frames
        mmco5 = any(m.op == 5 for m in (sh.mmcos or []))
        poc = layer.poc.compute(sps, sh, nh.ref_idc, nh.is_idr, mmco5)
        if nh.ref_idc != 0:
            fr = Frame(frame_num=sh.frame_num, poc=poc,
                       planes_pad=(edge_pad_device(padY),
                                   edge_pad_device(padU),
                                   edge_pad_device(padV)))
            layer.dpb.add(fr, mmcos=sh.mmcos or None, idr=nh.is_idr,
                          long_term_reference_flag=sh
                          .long_term_reference_flag)
            if layer.ring_key is not None:
                S = layer.ring_key[2]
                used = {f.slot for f in layer.dpb.frames
                        if f is not fr and f.slot >= 0}
                free = [s for s in range(S - 1) if s not in used]
                fr.slot = free[0] if free else -1
        return _PlanesFrame(planes), poc

    # ------------------------------------------------------------------
    def _deblock(self, pps: PPS, sd: SliceData, planes):
        """The frame deblock of a general-route picture, two CUDA kernels
        on a CUDA device: the parameters (``deblock_params_dec_fast``) on
        one upload of the picture's per-MB record, then the filter
        (``deblock_frame_aux_fast``).  The record holds its kinds (I4x4,
        I16, PCM and I_BL count as intra for the boundary strengths), QPs,
        MVs, refIdx, TotalCoeff, the slices' alpha/beta offsets and the
        edge flags.  planes PAD-padded int32; returns the new planes."""
        gw, gh = sd.gw, sd.gh
        fmb_v, fmb_h, fint = self._filter_flags(sd)
        rec = pack_deblock_record({
            "kind": sd.mb_kind, "qp": sd.qp, "mv": sd.mv,
            "ref_idx": sd.ref_idx,
            "nnz": sd.nnz_luma.reshape(gh, 4, gw, 4).transpose(0, 2, 1, 3),
            "alpha_off": sd.alpha_off, "beta_off": sd.beta_off,
            "fmb_v": fmb_v, "fmb_h": fmb_h, "fint": fint}, gw, gh)
        aux = deblock_params_dec_fast(
            torch.as_tensor(rec, device=self.device)[None], RECORD_OFFSETS,
            pps.chroma_qp_index_offset, gw=gw, gh=gh)[0]
        return deblock_frame_aux_fast(planes, aux, gw=gw, gh=gh)
