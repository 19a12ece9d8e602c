"""Shared parts of the port's stage tools (``port_decode_stages.py``,
``port_encode_stages.py``, ``port_svc_stages.py``): exclusive stage timing
by wrapping functions, the device's busy share under ``torch.profiler``,
and the card's name and power limit.  Needs a CUDA device.
"""
from __future__ import annotations

import inspect
import pathlib
import subprocess
import sys
import time
from collections import defaultdict

REPO = pathlib.Path(__file__).resolve().parent.parent


def use_tree(argv) -> str:
    """Import ``hartallo_tpu_torch`` from ``--tree DIR`` when given (a
    checkout of another commit, timed on this tree's fixtures), else from
    this tree; returns the tree's path."""
    tree = argv[argv.index("--tree") + 1] if "--tree" in argv else REPO
    tree = str(pathlib.Path(tree).resolve())
    sys.path.insert(0, tree)
    return tree


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


class Split:
    """Exclusive stage times per (layer, stage): a wrapped function's time,
    ended by ``torch.cuda.synchronize``, less the wrapped functions nested
    in it.  ``layer`` is set by the wrappers that know which layer is
    being worked on (0 for single-layer streams)."""

    def __init__(self):
        self.T = defaultdict(float)
        self.stack = []
        self.layer = [0]

    def timed(self, key, fn, layer_of=None):
        import torch

        def wrapper(*a, **k):
            if layer_of is not None:
                self.layer.append(layer_of(*a, **k))
            self.stack.append(0.0)
            t0 = time.perf_counter()
            try:
                r = fn(*a, **k)
                torch.cuda.synchronize()
            finally:
                dt = time.perf_counter() - t0
                self.T[(self.layer[-1], key)] += dt - self.stack.pop()
                if self.stack:
                    self.stack[-1] += dt
                if layer_of is not None:
                    self.layer.pop()
            return r
        return wrapper

    def run(self, patches, body):
        """Run body() with (obj, attr, key[, layer_of]) patches in place;
        returns its seconds."""
        patches = [(*p, None)[:4] for p in patches]
        saved = [(obj, attr, inspect.getattr_static(obj, attr))
                 for obj, attr, _, _ in patches]
        for obj, attr, key, layer_of in patches:
            f = inspect.getattr_static(obj, attr)
            if isinstance(f, staticmethod):
                f = staticmethod(self.timed(key, f.__func__, layer_of))
            else:
                f = self.timed(key, getattr(obj, attr), layer_of)
            setattr(obj, attr, f)
        try:
            t0 = time.perf_counter()
            body()
            return time.perf_counter() - t0
        finally:
            for obj, attr, f in saved:
                setattr(obj, attr, f)

    def per_picture(self, pictures):
        """{layer: {stage: ms per picture of that layer}}; ``pictures``
        maps a layer to its picture count."""
        out = defaultdict(dict)
        for (layer, key), v in sorted(self.T.items()):
            out[str(layer)][key] = v * 1e3 / pictures[layer]
        return dict(out)


def busy_share(body, pictures: int, top: int = 8) -> dict:
    """Run body() under ``torch.profiler``: the share of its wall time in
    which the card ran work (the device self times over wall time; the
    profiler slows the host, so a lower bound) and the device time of the
    ``top`` heaviest kernels and copies, ms per picture."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        body()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: a CPU op's device time repeats its kernels'
    dev = {e.key: e.self_device_time_total / 1e3
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total}
    if not dev:
        return {"busy_share": "not measured (the trace holds no device "
                "time)"}
    heavy = sorted(dev.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_share": sum(dev.values()) / (wall * 1e3),
            "device_ms_per_picture": {k: v / pictures for k, v in heavy}}


def hand_kernels() -> set:
    """The names of the ``__global__`` functions in the ``csrc`` of the
    ``hartallo_tpu_torch`` that is imported: the port's hand kernels."""
    import re

    import hartallo_tpu_torch
    csrc = pathlib.Path(hartallo_tpu_torch.__file__).parent / "csrc"
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                     r"\s*)?(\w+)")
    return {m.group(1) for f in sorted(csrc.glob("*.cu*"))
            for m in pat.finditer(f.read_text())}


def p_picture_kernels(W: int, H: int, top: int = 12) -> dict:
    """The device kernels, copies and fills that one P picture of the
    ``bench.make_clip`` clip at W x H launches (bench.py's settings), from
    ``torch.profiler``: an encode of two pictures (IDR, then P) less an
    encode of the IDR picture alone, each after a warm-up.  Split into the
    hand kernels (``hand_kernels``) and the rest, with the ``top`` most
    frequent of the rest by name."""
    from collections import Counter

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bench import make_clip
    from hartallo_tpu_torch.api import Codec, CodecConfig
    clip = make_clip(W, H, 2)

    def encode(n):
        Codec(CodecConfig(width=W, height=H, qp=30, gop_size=8, deblock=True,
                          me_range=12), device="cuda") \
            .encode_frames(clip[:n], W, H)
        torch.cuda.synchronize()

    def launches(n):
        encode(n)                                          # warm-up
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            encode(n)
        return Counter(e.name for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
    two, one = launches(2), launches(1)
    names = hand_kernels()
    hand, other = Counter(), Counter()
    for k in two:
        h = next((h for h in names if f"{h}(" in k or f"{h}<" in k), None)
        if h is None:
            other[k[:100]] += two[k] - one[k]
        else:
            hand[h] += two[k] - one[k]
    return {"hand": sum(hand.values()), "other": sum(other.values()),
            "hand_by_name": dict(hand),
            "other_top": dict(other.most_common(top))}
