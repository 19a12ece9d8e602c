"""Stage split of the PyTorch port's encode on a CUDA device.

    python tools/port_encode_stages.py [fixture ...]
    # default: cif_16 720p_8 1080p_8

For each fixture of tests/data/port, encodes its ``bench.make_clip`` clip
with bench.py's settings once as a warm-up, then once with the stages
wrapped, each ended by ``torch.cuda.synchronize`` and counted without the
stages nested in it: host ``pack_src`` and uploads, the intra kernel
(``intra_encode_frame_fast``: the IDR picture and every P picture with an
intra MB), integer full search and sub-pel refinement (the motion search
kernels, ``full_search_int_fast`` and ``refine_subpel_rounds_fast``, where
``p_device`` calls them), the rest of the P and I bodies, the deblock
kernel (parameter gather included), the fetch with MVD/skip derivation,
and CAVLC packing, with the three kernels' launches (one refinement
launch a P picture runs both rounds); then one encode of the whole clip
under ``torch.profiler`` for the device's busy share and its heaviest
kernels (the profiler takes about a millisecond for each of the eager P
bodies' small kernels).
Prints two JSON objects per fixture, in ms per frame, with the card's
name and power limit.  Needs a CUDA device.
"""
from __future__ import annotations

import json
import sys

from port_stages import REPO, Split, busy_share, card_line

sys.path.insert(0, str(REPO))


def _meta(name: str) -> dict:
    return json.loads((REPO / "tests" / "data" / "port" /
                       f"{name}.json").read_text())


def _encode(name: str):
    """Encode a fixture's clip on cuda; returns the frame count."""
    import torch

    from bench import make_clip
    from hartallo_tpu_torch.api import Codec, CodecConfig
    meta = _meta(name)
    W, H, NF = meta["width"], meta["height"], meta["frames"]
    clip = make_clip(W, H, NF)
    codec = Codec(CodecConfig(width=W, height=H, qp=30, gop_size=NF,
                              deblock=True, me_range=12), device="cuda")
    out = codec.encode_frames(clip, W, H)
    torch.cuda.synchronize()
    assert len(out) == NF
    return NF


def stages(name: str) -> dict:
    import hartallo_tpu_torch.encode.e_device as E
    import hartallo_tpu_torch.encode.encoder as EN
    import hartallo_tpu_torch.encode.intra_encode_fast as IF
    import hartallo_tpu_torch.encode.me_fast as MF
    import hartallo_tpu_torch.encode.p_device as PD

    _encode(name)                                             # warm-up
    patches = [(EN, "pack_src", "pack_src"),
               (EN.Encoder, "_tensor", "upload"),
               (E, "intra_encode_frame_fast", "intra_kernel"),
               (PD, "full_search_int_fast", "full_search"),
               (PD, "refine_subpel_rounds_fast", "subpel_refine"),
               (E, "_p_frame_body", "p_body_rest"),
               (EN, "i_frame_fused", "i_body_rest"),
               (E, "deblock_frame_fast", "deblock_kernel"),
               (EN.Encoder, "finish_frame", "fetch_mvd"),
               (EN.Encoder, "_pack_slices", "cavlc_pack")]
    S = Split()
    nf = []
    launches = (IF.LAUNCHES, MF.FULL_SEARCH_LAUNCHES, MF.REFINE_LAUNCHES)
    total = S.run(patches, lambda: nf.append(_encode(name)))
    ms = {key: v * 1e3 / nf[0] for (_, key), v in S.T.items()}
    ms["other_host"] = total * 1e3 / nf[0] - sum(ms.values())
    ms["total"] = total * 1e3 / nf[0]
    return {"fixture": name, "encode_ms_per_frame": ms,
            "intra_kernel_launches": IF.LAUNCHES - launches[0],
            "full_search_launches": MF.FULL_SEARCH_LAUNCHES - launches[1],
            "refine_launches": MF.REFINE_LAUNCHES - launches[2]}


def device_split(name: str) -> dict:
    """An encode of the clip under ``torch.profiler``
    (``port_stages.busy_share``)."""
    return {"fixture": name, **busy_share(lambda: _encode(name),
                                          _meta(name)["frames"])}


def main(names) -> None:
    card = card_line()
    for name in names or ("cif_16", "720p_8", "1080p_8"):
        print(json.dumps({"card": card, **stages(name)}), flush=True)
        print(json.dumps({"card": card, **device_split(name)}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
