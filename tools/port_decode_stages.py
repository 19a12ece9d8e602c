"""Stage split of the PyTorch port's decode on a CUDA device.

    python tools/port_decode_stages.py [--tree DIR] [--runs N] [fixture ...]
                                                          # default: all

For each fixture of tests/data/port, after one warm-up decode, times
``N`` decodes (default 1) with the stages wrapped (``port_stages.Split``:
each ended by ``torch.cuda.synchronize`` and counted without the wrapped
stages nested in it): host CAVLC parse, host enqueue (MV derivation and
payload packing), the host part of the flushes (payload upload and
launches), the kernel route and the GOP-scan route, and the output
fetch; then one decode under ``torch.profiler`` for the device's busy
share and its heaviest kernels.  Prints two JSON objects per fixture, in
ms per frame, with the card's name and power limit.  ``--tree`` imports
``hartallo_tpu_torch`` from a checkout of another commit, so that two
trees are split with the same wrappers on one card (run them in turns in
one command).  Needs a CUDA device.
"""
from __future__ import annotations

import json
import sys
import time

from port_stages import REPO, Split, busy_share, card_line, use_tree

FIXTURES = REPO / "tests" / "data" / "port"


def stages(name: str, runs: int) -> dict:
    import torch

    import hartallo_tpu_torch.decode.decoder as DM
    from hartallo_tpu_torch.api import Codec, CodecConfig

    stream = (FIXTURES / f"{name}.264").read_bytes()
    nf = json.loads((FIXTURES / f"{name}.json").read_text())["frames"]
    Codec(CodecConfig(), device="cuda").decode_annexb(stream)   # warm-up
    torch.cuda.synchronize()
    patches = [(DM.SliceDecoder, "decode_slice_data", "parse"),
               (DM.Decoder, "_enqueue_batched", "enqueue"),
               (DM.Decoder, "_flush", "flush"),
               (DM, "decode_gop_fast", "kernel_route"),
               (DM, "decode_gop", "scan_route"),
               (DM._BatchOut, "fetch", "fetch")]
    S = Split()
    routes = []

    def body():
        for _ in range(runs):
            codec = Codec(CodecConfig(), device="cuda")
            out = codec.decode_annexb(stream, tolerant=False)
            torch.cuda.synchronize()
            assert len(out) == nf
            routes.append(codec.decoder.stats)

    total = S.run(patches, body)
    ms = {key: v * 1e3 / (nf * runs) for (_, key), v in S.T.items()}
    ms["total"] = total * 1e3 / (nf * runs)
    return {"fixture": name, "runs": runs, "ms_per_frame": ms,
            "routes": routes[-1]}


def device_split(name: str) -> dict:
    from hartallo_tpu_torch.api import Codec, CodecConfig
    stream = (FIXTURES / f"{name}.264").read_bytes()
    nf = json.loads((FIXTURES / f"{name}.json").read_text())["frames"]
    return {"fixture": name, **busy_share(
        lambda: Codec(CodecConfig(), device="cuda").decode_annexb(stream),
        nf)}


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
                          "qcif_6_wp"):
        print(json.dumps({**card, **stages(name, runs)}), flush=True)
        print(json.dumps({**card, **device_split(name)}), flush=True)
    print(f"port_decode_stages: {time.perf_counter() - t0:.1f} s",
          flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
