"""Stage split of the PyTorch port's decode on a CUDA device.

    python tools/port_decode_stages.py [fixture ...]     # default: all

For each fixture of tests/data/port, after one warm-up decode, times one
decode with the stages wrapped: host CAVLC parse, host enqueue (MV
derivation and payload packing), the kernel route and the GOP-scan route
(each ended by ``torch.cuda.synchronize``), and the output fetch; then
one decode under ``torch.profiler`` for the device's busy share and its
heaviest kernels.  Prints two JSON objects per fixture, in ms per frame,
with the card's name and power limit.  Needs a CUDA device.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def _timed(T, key, fn, sync=False):
    """Wrap fn so that its time adds to T[key]; an enqueue's time leaves
    out the flushes nested in it."""
    import torch

    def wrapper(*a, **k):
        nested = T["flush"] + T["fetch"]
        t0 = time.perf_counter()
        r = fn(*a, **k)
        if sync:
            torch.cuda.synchronize()
        T[key] += time.perf_counter() - t0
        if key == "enqueue":
            T[key] -= T["flush"] + T["fetch"] - nested
        return r
    return wrapper


def stages(name: str) -> dict:
    import torch

    import hartallo_tpu_torch.decode.decoder as DM
    from hartallo_tpu_torch.api import Codec, CodecConfig

    stream = (REPO / "tests" / "data" / "port" / f"{name}.264").read_bytes()
    nf = json.loads((REPO / "tests" / "data" / "port" /
                     f"{name}.json").read_text())["frames"]
    Codec(CodecConfig(), device="cuda").decode_annexb(stream)   # warm-up
    torch.cuda.synchronize()
    T = dict.fromkeys(("parse", "enqueue", "flush", "kernel_route",
                       "scan_route", "fetch"), 0.0)
    patches = [(DM.SliceDecoder, "decode_slice_data", "parse", False),
               (DM.Decoder, "_enqueue_batched", "enqueue", False),
               (DM.Decoder, "_flush", "flush", False),
               (DM, "decode_gop_fast", "kernel_route", True),
               (DM, "decode_gop", "scan_route", True),
               (DM._BatchOut, "fetch", "fetch", False)]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _, _ in patches]
    for obj, attr, key, sync in patches:
        setattr(obj, attr, _timed(T, key, getattr(obj, attr), sync))
    try:
        codec = Codec(CodecConfig(), device="cuda")
        t0 = time.perf_counter()
        out = codec.decode_annexb(stream, tolerant=False)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)
    assert len(out) == nf
    ms = {k: v * 1e3 / nf for k, v in T.items()}
    # "flush" (host payload upload and launches) holds the two routes,
    # "enqueue" the flushes it triggers at batch_k
    ms["flush"] -= ms["kernel_route"] + ms["scan_route"]
    ms["total"] = total * 1e3 / nf
    return {"fixture": name, "ms_per_frame": ms,
            "routes": codec.decoder.stats}


def device_split(name: str, top: int = 8) -> dict:
    """One decode under ``torch.profiler``: the share of its wall time in
    which the card ran work (the sum of device self times over wall time;
    the profiler's own cost makes it a lower bound) and the device time of
    the ``top`` heaviest kernels and copies, ms per frame."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hartallo_tpu_torch.api import Codec, CodecConfig

    stream = (REPO / "tests" / "data" / "port" / f"{name}.264").read_bytes()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = Codec(CodecConfig(), device="cuda").decode_annexb(stream)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: a CPU op's device time repeats its kernels'
    dev = {e.key: e.self_device_time_total / 1e3
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total}
    if not dev:
        return {"fixture": name, "busy_share": "not measured (the trace "
                "holds no device time)"}
    heavy = sorted(dev.items(), key=lambda kv: -kv[1])[:top]
    return {"fixture": name,
            "busy_share": sum(dev.values()) / (wall * 1e3),
            "device_ms_per_frame": {k: v / len(out) for k, v in heavy}}


def main(names) -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for name in names or ("qcif_8", "cif_16", "720p_8", "1080p_8",
                          "qcif_6_wp"):
        print(json.dumps({"card": card, **stages(name)}), flush=True)
        print(json.dumps({"card": card, **device_split(name)}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
