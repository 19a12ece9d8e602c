"""Stage split of the PyTorch port's encode on a CUDA device.

    python tools/port_encode_stages.py [--tree DIR] [fixture ...]
    # default: cif_16 720p_8 1080p_8

For each fixture of tests/data/port, encodes its ``bench.make_clip`` clip
with bench.py's settings once as a warm-up, then once with the stages
wrapped (the clip and the ``Codec`` made before the clock starts, so that
no stage holds the clip's synthesis), each ended by
``torch.cuda.synchronize`` and counted without the stages nested in it: host ``pack_src`` and uploads, the intra kernel
(``intra_encode_frame_fast``: the IDR picture and every P picture with an
intra MB), integer full search and sub-pel refinement (the motion search
kernels, ``full_search_int_fast`` and ``refine_subpel_rounds_fast``, where
``p_device`` calls them), the P body kernels where the tree has them
(``partition_decide_fast``, ``halfpel_planes_fast``, ``p_residual_fast``
as ``part_decide``, ``halfpel``, ``p_residual``, and
``deblock_params_fast`` as ``deblock_params``), the rest of the P and I
bodies (what stays eager), the deblock kernel (its launch; on a tree
without ``deblock_frame_aux_fast`` the wrapper with its parameter
gather), the fetch with MVD/skip derivation, and CAVLC packing, with the
kernels' launches (one refinement launch a P picture runs both rounds);
then one encode of the whole clip under ``torch.profiler`` for the
device's busy share and its heaviest kernels, and the device kernels of
one P picture at the clip's size (``port_stages.p_picture_kernels``: the
hand kernels and the rest).  ``--tree DIR`` imports
``hartallo_tpu_torch`` from another checkout (a parent commit, split on
the same card in turns with this tree).
Prints three JSON objects per fixture, in ms per frame, with the card's
name and power limit.  Needs a CUDA device.
"""
from __future__ import annotations

import json
import sys

from port_stages import (REPO, Split, busy_share, card_line,
                         p_picture_kernels, use_tree)

TREE = use_tree(sys.argv)
sys.path.insert(1, str(REPO))


def _meta(name: str) -> dict:
    return json.loads((REPO / "tests" / "data" / "port" /
                       f"{name}.json").read_text())


def _prepare(name: str):
    """A fixture's clip and a new ``Codec`` on cuda with bench.py's
    settings, made before any clock starts (as ``chip_smoke.encode_clip``
    makes them): (codec, clip, W, H)."""
    from bench import make_clip
    from hartallo_tpu_torch.api import Codec, CodecConfig
    meta = _meta(name)
    W, H, NF = meta["width"], meta["height"], meta["frames"]
    codec = Codec(CodecConfig(width=W, height=H, qp=30, gop_size=NF,
                              deblock=True, me_range=12), device="cuda")
    return codec, make_clip(W, H, NF), W, H


def _encode(prepared):
    """Encode a prepared clip (``_prepare``); returns the frame count."""
    import torch
    codec, clip, W, H = prepared
    out = codec.encode_frames(clip, W, H)
    torch.cuda.synchronize()
    assert len(out) == len(clip)
    return len(out)


def stages(name: str) -> dict:
    import hartallo_tpu_torch.encode.e_device as E
    import hartallo_tpu_torch.encode.encoder as EN
    import hartallo_tpu_torch.encode.intra_encode_fast as IF
    import hartallo_tpu_torch.encode.me_fast as MF
    import hartallo_tpu_torch.encode.p_device as PD

    _encode(_prepare(name))                                   # warm-up
    db = "deblock_frame_aux_fast" if hasattr(E, "deblock_frame_aux_fast") \
        else "deblock_frame_fast"
    patches = [(EN, "pack_src", "pack_src"),
               (EN.Encoder, "_tensor", "upload"),
               (E, "intra_encode_frame_fast", "intra_kernel"),
               (PD, "full_search_int_fast", "full_search"),
               (PD, "refine_subpel_rounds_fast", "subpel_refine"),
               (PD, "partition_decide_fast", "part_decide"),
               (PD, "halfpel_planes_fast", "halfpel"),
               (PD, "p_residual_fast", "p_residual"),
               (E, "deblock_params_fast", "deblock_params"),
               (E, "_p_frame_body", "p_body_rest"),
               (EN, "i_frame_fused", "i_body_rest"),
               (E, db, "deblock_kernel"),
               (EN.Encoder, "finish_frame", "fetch_mvd"),
               (EN.Encoder, "_pack_slices", "cavlc_pack")]
    patches = [p for p in patches if hasattr(p[0], p[1])]
    S = Split()
    nf = []
    launches = (IF.LAUNCHES, MF.FULL_SEARCH_LAUNCHES, MF.REFINE_LAUNCHES)
    PB = sys.modules.get("hartallo_tpu_torch.encode.p_body_fast")
    pb = dict(PB.LAUNCHES) if PB else {}
    prepared = _prepare(name)
    total = S.run(patches, lambda: nf.append(_encode(prepared)))
    ms = {key: v * 1e3 / nf[0] for (_, key), v in S.T.items()}
    ms["other_host"] = total * 1e3 / nf[0] - sum(ms.values())
    ms["total"] = total * 1e3 / nf[0]
    return {"fixture": name, "tree": TREE, "encode_ms_per_frame": ms,
            "intra_kernel_launches": IF.LAUNCHES - launches[0],
            "full_search_launches": MF.FULL_SEARCH_LAUNCHES - launches[1],
            "refine_launches": MF.REFINE_LAUNCHES - launches[2],
            "p_body_launches": {k: PB.LAUNCHES[k] - v
                                for k, v in pb.items()}}


def device_split(name: str) -> dict:
    """An encode of the clip under ``torch.profiler``
    (``port_stages.busy_share``), the clip and codec made before it."""
    prepared = _prepare(name)
    return {"fixture": name, **busy_share(lambda: _encode(prepared),
                                          _meta(name)["frames"])}


def main(argv) -> None:
    names = [a for i, a in enumerate(argv)
             if a != "--tree" and (i == 0 or argv[i - 1] != "--tree")]
    card = card_line()
    for name in names or ("cif_16", "720p_8", "1080p_8"):
        meta = _meta(name)
        print(json.dumps({"card": card, **stages(name)}), flush=True)
        print(json.dumps({"card": card, **device_split(name)}), flush=True)
        print(json.dumps({"card": card, "fixture": name, "tree": TREE,
                          "p_picture_kernels": p_picture_kernels(
                              meta["width"], meta["height"])}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
