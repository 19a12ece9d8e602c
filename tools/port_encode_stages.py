"""Stage split of the PyTorch port's encode on a CUDA device.

    python tools/port_encode_stages.py [fixture ...]   # default: cif_16 720p_8

For each fixture of tests/data/port, encodes its ``bench.make_clip`` clip
with bench.py's settings once as a warm-up, then once with the stages
wrapped, each ended by ``torch.cuda.synchronize`` and counted without the
stages nested in it: host ``pack_src`` and uploads, the intra wavefront,
integer full search, sub-pel refinement, the rest of the P and I bodies,
the deblock kernel (parameter gather included), the fetch with MVD/skip
derivation, and CAVLC packing; then an encode of the clip's first
``PROFILE_FRAMES`` frames (the IDR picture alone) under ``torch.profiler``
for the device's busy share and its heaviest kernels: the eager intra
wavefront issues some 10^5 small kernels per picture, and the profiler
takes about a millisecond for each (a 720p IDR picture profiles in a few
minutes, a whole 720p clip in far more than ten).  Prints two JSON
objects per fixture, in ms per frame, with the card's name and power
limit.  Needs a CUDA device.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
PROFILE_FRAMES = 1


def _encode(name: str, frames: int = 0):
    """Encode a fixture's clip (its first ``frames`` frames when given)
    on cuda; returns the frame count."""
    import torch

    from bench import make_clip
    from hartallo_tpu_torch.api import Codec, CodecConfig
    meta = json.loads((REPO / "tests" / "data" / "port" /
                       f"{name}.json").read_text())
    W, H, NF = meta["width"], meta["height"], frames or meta["frames"]
    clip = make_clip(W, H, NF)
    codec = Codec(CodecConfig(width=W, height=H, qp=30, gop_size=NF,
                              deblock=True, me_range=12), device="cuda")
    out = codec.encode_frames(clip, W, H)
    torch.cuda.synchronize()
    assert len(out) == NF
    return NF


def _timed(T, stack, key, fn):
    """Wrap fn so that its exclusive time (its own, less the wrapped
    stages nested in it) adds to T[key]; the device is synchronised at
    its end."""
    import torch

    def wrapper(*a, **k):
        stack.append(0.0)
        t0 = time.perf_counter()
        try:
            r = fn(*a, **k)
            torch.cuda.synchronize()
        finally:
            dt = time.perf_counter() - t0
            T[key] += dt - stack.pop()
            if stack:
                stack[-1] += dt
        return r
    return wrapper


def stages(name: str) -> dict:
    import torch

    import hartallo_tpu_torch.encode.e_device as E
    import hartallo_tpu_torch.encode.encoder as EN
    import hartallo_tpu_torch.encode.p_device as PD

    _encode(name)                                             # warm-up
    patches = [(EN, "pack_src", "pack_src"),
               (EN.Encoder, "_tensor", "upload"),
               (E, "intra_encode_frame", "intra_wavefront"),
               (PD, "full_search_int", "full_search"),
               (PD, "refine_subpel", "subpel_refine"),
               (E, "_p_frame_body", "p_body_rest"),
               (EN, "i_frame_fused", "i_body_rest"),
               (E, "deblock_frame_fast", "deblock_kernel"),
               (EN.Encoder, "finish_frame", "fetch_mvd"),
               (EN.Encoder, "_pack_slices", "cavlc_pack")]
    T = {key: 0.0 for _, _, key in patches}
    stack = []
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    for obj, attr, key in patches:
        setattr(obj, attr, _timed(T, stack, key, getattr(obj, attr)))
    try:
        t0 = time.perf_counter()
        nf = _encode(name)
        total = time.perf_counter() - t0
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)
    ms = {k: v * 1e3 / nf for k, v in T.items()}
    ms["other_host"] = total * 1e3 / nf - sum(ms.values())
    ms["total"] = total * 1e3 / nf
    return {"fixture": name, "encode_ms_per_frame": ms}


def device_split(name: str, top: int = 8) -> dict:
    """An encode of the first PROFILE_FRAMES frames under
    ``torch.profiler``: the share of its wall time in which the card ran
    work (device self time over wall time; a lower
    bound, the profiler slows the host) and the device time of the
    ``top`` heaviest kernels and copies, ms per frame."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        nf = _encode(name, PROFILE_FRAMES)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = {e.key: e.self_device_time_total / 1e3
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total}
    if not dev:
        return {"fixture": name, "busy_share": "not measured (the trace "
                "holds no device time)"}
    heavy = sorted(dev.items(), key=lambda kv: -kv[1])[:top]
    return {"fixture": name,
            "busy_share": sum(dev.values()) / (wall * 1e3),
            "device_ms_per_frame": {k: v / nf for k, v in heavy}}


def main(names) -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for name in names or ("cif_16", "720p_8"):
        print(json.dumps({"card": card, **stages(name)}), flush=True)
        print(json.dumps({"card": card, **device_split(name)}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
