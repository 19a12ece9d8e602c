"""Stage split of the PyTorch port's decode on a CUDA device.

    python tools/port_decode_stages.py [--tree DIR] [--runs N] [fixture ...]
                                                          # default: all

For each fixture of tests/data/port, after one warm-up decode, times
``N`` decodes (default 1) with the stages wrapped (``port_stages.Split``:
each ended by ``torch.cuda.synchronize`` and counted without the wrapped
stages nested in it): host CAVLC parse, host enqueue (MV derivation and
payload packing), the host part of the flushes (payload upload and
launches), the kernel route, and the GOP-scan route split into its
stages (where the tree has them): ``scan_upload`` (the batch's one
asynchronous int16 copy from the page-locked host buffer to the card,
``staging.RowStaging.upload``, ended by the synchronize; the rows are
packed into that buffer in ``enqueue``, and on a tree without it their
``np.stack`` counts in ``flush``), ``scan_loop`` (the scan's own loop: on a
tree without ``scan_upload`` also the batch's upload and widening, and
on a tree without a ring write kernel the ring write's eager ops),
``scan_batch_rest`` (the batch's eager work),
``scan_residual`` (the residual kernel, or the eager
``residual_planes_wide``), ``scan_deblock_params``, ``scan_mc`` (the MC
kernel; on a tree without it, ``reconstruct_picture`` less its nested
stages: the eager MC, residual add and pad), ``scan_picture_rest``,
``scan_intra``, ``scan_deblock`` and ``scan_ring_write`` (the ring write
kernel, or the half-pel stack launch that a tree without it makes
there); then the output fetch.  A ``shard_*`` fixture is decoded by
``decode_gops_grouped`` on ``Mesh(("cuda:0",) * 4)`` in 2 groups,
its band step (``band_step``) split the same way (``band_halfpel``: the
band's reference stacks; ``band_upload``: its bands' copies of the
picture's rows, ``shard._split``).  Then one decode under
``torch.profiler`` for the device's busy share and its heaviest
kernels, and the device operations (kernels, copies, fills) that the
scan route or the band step launches per picture (its runtime calls
inside its window; hand kernels apart).  Prints three JSON objects per
fixture, in ms per frame, with the card's name and power limit.
``--tree`` imports ``hartallo_tpu_torch`` from a checkout of another
commit, so that two trees are split with the same wrappers on one card
(run them in turns in one command).  Needs a CUDA device.
"""
from __future__ import annotations

import json
import sys
import time

from port_stages import (REPO, Split, busy_share, card_line,
                         hand_kernels, use_tree)

FIXTURES = REPO / "tests" / "data" / "port"


SHARD_BANDS = 4


def decoder(name: str):
    """fn() decoding the fixture: ``Codec.decode_annexb``, or for a
    ``shard_*`` fixture ``decode_gops_grouped`` on SHARD_BANDS bands of
    one card in 2 groups; returns the frames."""
    from hartallo_tpu_torch.api import Codec, CodecConfig
    stream = (FIXTURES / f"{name}.264").read_bytes()
    if name.startswith("shard"):
        from hartallo_tpu_torch.parallel.shard import (Mesh,
                                                       decode_gops_grouped)
        return lambda: decode_gops_grouped(Mesh(("cuda:0",) * SHARD_BANDS),
                                           stream, groups=2)
    return lambda: Codec(CodecConfig(), device="cuda").decode_annexb(
        stream, tolerant=False)


def stages(name: str, runs: int) -> dict:
    import torch

    import hartallo_tpu_torch.decode.d_gop as G
    import hartallo_tpu_torch.decode.decoder as DM
    import hartallo_tpu_torch.parallel.shard as S

    try:
        from hartallo_tpu_torch.decode.staging import RowStaging
    except ImportError:                    # a tree without the staging
        RowStaging = None
    nf = json.loads((FIXTURES / f"{name}.json").read_text())["frames"]
    decode = decoder(name)
    decode()                                               # warm-up
    torch.cuda.synchronize()
    mc = "scan_mc"
    if hasattr(G, "mc_recon_fast"):
        mc = "scan_picture_rest"
    patches = [(DM.SliceDecoder, "decode_slice_data", "parse"),
               (DM.Decoder, "_enqueue_batched", "enqueue"),
               (DM.Decoder, "_flush", "flush"),
               (DM, "decode_gop_fast", "kernel_route"),
               (DM, "decode_gop", "scan_loop"),
               (RowStaging, "upload", "scan_upload"),
               (S, "decode_frame_step_sharded", "band_step"),
               (S, "_split", "band_upload"),
               (S, "halfpel_planes_fast", "band_halfpel"),
               (G, "prepare_pictures", "scan_batch_rest"),
               (S, "prepare_pictures", "scan_batch_rest"),
               (G, "residual_planes_fast", "scan_residual"),
               (G, "residual_planes_wide", "scan_residual"),
               (G, "deblock_params_dec_fast", "scan_deblock_params"),
               (G, "reconstruct_picture", mc),
               (S, "reconstruct_picture", mc),
               (G, "mc_recon_fast", "scan_mc"),
               (G, "intra_reconstruct_fast", "scan_intra"),
               (G, "deblock_frame_aux_fast", "scan_deblock"),
               (G, "ring_write_fast", "scan_ring_write"),
               (G, "halfpel_planes_fast", "scan_ring_write"),
               (DM._BatchOut, "fetch", "fetch")]
    patches = [p for p in patches if hasattr(p[0], p[1])]
    split = Split()

    def body():
        for _ in range(runs):
            out = decode()
            torch.cuda.synchronize()
            assert len(out) == nf

    total = split.run(patches, body)
    ms = {key: v * 1e3 / (nf * runs) for (_, key), v in split.T.items()}
    ms["total"] = total * 1e3 / (nf * runs)
    return {"fixture": name, "runs": runs, "ms_per_frame": ms}


def device_split(name: str) -> dict:
    nf = json.loads((FIXTURES / f"{name}.json").read_text())["frames"]
    return {"fixture": name, **busy_share(decoder(name), nf)}


def scan_ops(name: str) -> dict:
    """The device operations that the scan route (``decoder.decode_gop``)
    or the band step (``shard.decode_frame_step_sharded``) launches per
    picture (band picture): one decode after a warm-up under
    ``torch.profiler``, the route marked with ``record_function``; each
    runtime launch, copy or fill call inside its windows, with its device
    operation's name, the hand kernels (``port_stages.hand_kernels``)
    apart from the rest."""
    from collections import Counter

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    import hartallo_tpu_torch.decode.decoder as DM
    import hartallo_tpu_torch.parallel.shard as S
    shard = name.startswith("shard")
    mod, attr = (S, "decode_frame_step_sharded") if shard else \
        (DM, "decode_gop")
    real, pictures = getattr(mod, attr), [0]

    def marked(*args, **kw):
        pictures[0] += SHARD_BANDS if shard else len(args[1])
        with record_function("hl_route"):
            return real(*args, **kw)
    decode = decoder(name)
    decode()
    torch.cuda.synchronize()
    setattr(mod, attr, marked)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            decode()
            torch.cuda.synchronize()
    finally:
        setattr(mod, attr, real)
    events = prof.events()
    windows = np.array([(e.time_range.start, e.time_range.end)
                        for e in events if e.name == "hl_route"])
    if not len(windows) or not pictures[0]:
        return {"fixture": name, "route_ops": "not measured"}
    device = {e.id: e.name for e in events
              if e.device_type == DeviceType.CUDA}
    calls = [e for e in events if e.device_type == DeviceType.CPU and
             any(w in e.name for w in ("Launch", "Memcpy", "Memset")) and
             ((windows[:, 0] <= e.time_range.start) &
              (e.time_range.start <= windows[:, 1])).any()]
    hand_names = hand_kernels()
    hand, other = Counter(), Counter()
    for e in calls:
        op = device.get(e.id, e.name)
        h = next((h for h in hand_names
                  if f"{h}(" in op or f"{h}<" in op), None)
        if h is None:
            other[op[:80]] += 1
        else:
            hand[h] += 1
    n = pictures[0]
    return {"fixture": name, "route_pictures": n,
            "route_ops_per_picture": len(calls) / n,
            "hand_per_picture": {k: v / n for k, v in sorted(hand.items())},
            "other_per_picture": sum(other.values()) / n,
            "other_top": {k: v / n for k, v in other.most_common(10)}}


def main(argv) -> None:
    tree = use_tree(argv)
    runs = int(argv[argv.index("--runs") + 1]) if "--runs" in argv else 1
    names = [a for i, a in enumerate(argv) if not a.startswith("--") and
             (i == 0 or argv[i - 1] not in ("--tree", "--runs"))]
    from hartallo_tpu_torch import kernels
    kernels.build()
    card = {"card": card_line(), "tree": tree}
    t0 = time.perf_counter()
    for name in names or ("qcif_8", "cif_16", "720p_8", "1080p_8",
                          "qcif_6_wp", "1080p_8_wp", "shard_1080p_8"):
        print(json.dumps({**card, **stages(name, runs)}), flush=True)
        print(json.dumps({**card, **device_split(name)}), flush=True)
        if name.endswith("_wp") or name.startswith("shard"):
            print(json.dumps({**card, **scan_ops(name)}), flush=True)
    print(f"port_decode_stages: {time.perf_counter() - t0:.1f} s",
          flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
