"""Stage split of the PyTorch port's SVC decode and encode on a CUDA
device, per layer.

    python tools/port_svc_stages.py [fixture ...]     # default: svc3_4cif_8

For each SVC fixture of tests/data/port, after one warm-up, times one
decode and one encode of the fixture's clips (``tests/_torch_port
.layer_clips``) with the stages wrapped, each ended by
``torch.cuda.synchronize`` and counted without the wrapped stages nested
in it, and each charged to the layer (DQId) being decoded or encoded:

- decode: host CAVLC parse, inter-layer motion inference, the I_BL
  upsampling, ``decode_frame_pre``, the intra wavefront kernel, the
  deblock parameter kernel, the deblock kernel, the batched route's host
  enqueue
  and its kernel route, the rS / coefficient state kept for the next
  layer, the residual resampling, the rest of the general route and of
  the flushes, and the output fetch;
- encode: the base layer's AVC stages (``pack_src`` and uploads, the
  intra kernel, full search, sub-pel refinement, the rest of the P and I
  bodies, fetch with MVD/skip, CAVLC packing), the enhancement layers'
  upsampling, inferred-motion MC, motion inference, residual-prediction
  host work, transform and quantisation, the fetch of the levels and
  their CAVLC packing, and the deblock kernel for every layer (its
  parameter kernel inside the P and I bodies).

Then one decode under ``torch.profiler`` for the device's busy share.
Prints JSON objects in ms per picture of each layer, with the card's name
and power limit.  Needs a CUDA device.
"""
from __future__ import annotations

import json
import sys
from collections import defaultdict

from port_stages import REPO, Split, busy_share, card_line

sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))


def _nal_dqid(self, r, nh):
    return nh.svc.dqid if (nh.type == 20 and nh.svc) else 0


def decode_split(name: str) -> dict:
    import torch

    import hartallo_tpu_torch.decode.d_device as DD
    import hartallo_tpu_torch.decode.decoder as DM
    import hartallo_tpu_torch.svc.upsample as UP
    from _torch_port import load_fixture
    from hartallo_tpu_torch.api import Codec, CodecConfig

    stream, meta = load_fixture(name)
    Codec(CodecConfig()).decode_annexb(stream)               # warm-up
    torch.cuda.synchronize()
    S = Split()

    def layer_dqid(self, layer):
        return next(d for d, lay in self.layers.items() if lay is layer)

    patches = [
        (DM.Decoder, "_decode_slice", "other_host", _nal_dqid),
        (DM.Decoder, "_flush", "flush_rest", layer_dqid),
        (DM, "_materialize", "fetch", lambda r: r.dqid),
        (DM.SliceDecoder, "decode_slice_data", "parse", None),
        (DM.Decoder, "_infer_inter_layer_motion", "motion_inference", None),
        (UP, "upsample_plane", "upsample", None),
        (UP, "upsample_residual_plane_np", "residual_resample", None),
        (DD, "decode_frame_pre", "decode_frame_pre", None),
        (DM, "intra_reconstruct_fast", "intra", None),
        (DM, "deblock_params_dec_fast", "deblock_params", None),
        (DM, "deblock_frame_aux_fast", "deblock_kernel", None),
        (DM.Decoder, "_enqueue_batched", "enqueue", None),
        (DM, "decode_gop_fast", "kernel_route", None),
        (DM.d_pool, "residual_planes_np", "layer_state", None),
        (DM.Decoder, "_reconstruct_general", "general_rest", None)]
    codec = Codec(CodecConfig())
    out = []
    total = S.run(patches, lambda: out.extend(
        codec.decode_annexb(stream, tolerant=False)))
    pictures = defaultdict(int)
    for r in out:
        pictures[r.dqid] += 1
    return {"fixture": name, "decode_ms_per_picture": S.per_picture(
        pictures), "pictures": dict(pictures), "routes": codec.decoder.stats,
        "total_ms_per_access_unit": total * 1e3 / meta["frames"]}


def encode_split(name: str) -> dict:
    import torch

    import hartallo_tpu_torch.encode.e_device as E
    import hartallo_tpu_torch.encode.encoder as EN
    import hartallo_tpu_torch.encode.p_device as PD
    import hartallo_tpu_torch.encode.svc as SV
    from _torch_port import layer_clips, load_fixture, svc_config
    from hartallo_tpu_torch.api import Codec, CodecConfig

    meta = load_fixture(name)[1]
    clips = layer_clips(meta)

    def encode():
        codec = Codec(svc_config(CodecConfig, meta))
        for t in range(meta["frames"]):
            for (w, h), clip in zip(meta["layers"], clips):
                codec.encode(clip[t], w, h)
        torch.cuda.synchronize()

    encode()                                                  # warm-up
    S = Split()
    Q = SV.SvcEncoder
    patches = [
        (Q, "encode_frame", "other_host",
         lambda self, *a: self._call % len(self.layers)),
        (EN, "pack_src", "pack_src", None),
        (EN.Encoder, "_tensor", "upload", None),
        (E, "intra_encode_frame_fast", "intra_kernel", None),
        (PD, "full_search_int_fast", "full_search", None),
        (PD, "refine_subpel_rounds_fast", "subpel_refine", None),
        (E, "_p_frame_body", "p_body_rest", None),
        (EN, "i_frame_fused", "i_body_rest", None),
        (E, "deblock_frame_aux_fast", "deblock_kernel", None),
        (EN.Encoder, "finish_frame", "fetch_mvd", None),
        (EN.Encoder, "_pack_slices", "cavlc_pack", None),
        (SV, "upsample_plane", "upsample", None),
        (SV, "_ilp_predict", "mc", None),
        (SV, "infer_motion", "motion_inference", None),
        (SV, "_residual_planes_from_coeffs", "residual_pred_host", None),
        (SV, "upsample_residual_plane_np", "residual_pred_host", None),
        (Q, "_luma_quant", "transform_quant", None),
        (Q, "_chroma_quant", "transform_quant", None),
        (Q, "_chroma_recon", "transform_quant", None),
        (Q, "_arrays", "fetch_levels", None),
        (Q, "_pack_ibl_frame", "cavlc_pack", None),
        (Q, "_pack_ep_frame", "cavlc_pack", None)]
    total = S.run(patches, encode)
    nf = meta["frames"]
    return {"fixture": name, "encode_ms_per_picture": S.per_picture(
        defaultdict(lambda: nf)),
        "total_ms_per_access_unit": total * 1e3 / nf}


def device_split(name: str) -> dict:
    """One decode under ``torch.profiler`` (``port_stages.busy_share``),
    per access unit."""
    from _torch_port import load_fixture
    from hartallo_tpu_torch.api import Codec, CodecConfig
    stream, meta = load_fixture(name)
    share = busy_share(lambda: Codec(CodecConfig()).decode_annexb(stream),
                       meta["frames"])
    return {"fixture": name, "decode_busy_share": share.pop("busy_share"),
            "device_ms_per_access_unit": share.get("device_ms_per_picture")}


def main(names) -> None:
    card = card_line()
    for name in names or ("svc3_4cif_8",):
        print(json.dumps({"card": card, **decode_split(name)}), flush=True)
        print(json.dumps({"card": card, **encode_split(name)}), flush=True)
        print(json.dumps({"card": card, **device_split(name)}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
