"""The entries that a traffic mix drives (its ``entry`` key names one).

An entry is made for one run of one cell: ``setup`` makes the seed's
clip and its stream and warms the program up on one segment; ``window``
drives the program's entry in a closed loop, one chunk a call, cycling
the segment, for the run's seconds and on to the end of the segment;
``release`` frees the program's state; ``check`` holds what the window
returned against the plain reference and returns the numbers compared,
each with its limit.

A traffic file holds:
``entry``: ``DecodeIngest``;
``segment``: pictures in the cycled segment (one IDR period);
``chunk``: pictures handed to the entry a call;
``pan_px_per_frame``, ``objects``, ``noise``: the clip
(``clip.make_segment``'s ``pan``, ``objects`` and ``noise``);
``check_pictures``: pictures the reference checks: each call's first
picture, then P pictures drawn from the seed;
``check_after``: the first place of the segment a drawn picture may
take (the clip's objects have entered by then);
``check_workers``: processes the reference runs in.

``check`` returns the numbers compared, and with ``control`` the same
numbers with the control's outputs in the program's place (the reference
computed with the error that a faster program might be tempted by), for
``harness.verdict`` to judge alike.
"""
from __future__ import annotations

import gc
import os
import sys
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np

from portbench.clip import make_segment


class Window:
    """What the measured window did: pictures handed and returned, its
    wall time and rate, the outputs by call, the program's counters."""

    def __init__(self):
        self.attempted = 0
        self.completed = 0
        self.failed = 0
        self.wall_s = 0.0
        self.rate = 0.0
        self.error = None
        self.outputs = []          # (first segment index, [output, ...])
        self.call_s = []           # (first segment index, seconds)
        self.counters = {}
        self.idr_pictures = 0


def _workers(n: int) -> int:
    return max(1, min(n, os.cpu_count() or 1))


def _pool(workers: int, threads: int, *initargs):
    from portbench.reference import check
    return ProcessPoolExecutor(max_workers=workers,
                               mp_context=get_context("spawn"),
                               initializer=check.init,
                               initargs=(threads, *initargs))


class DecodeIngest:
    """``Codec.decode_annexb`` on each chunk's Annex-B bytes, every frame
    fetched to the host, one decoder session across chunks and cycles;
    the stream is the seed's clip encoded by ``Codec.encode_frames`` at
    the configuration's settings."""

    def __init__(self, cell, seed: int, device: str):
        self.cell = cell
        self.seed = int(seed)
        self.device = device
        c, t = cell.config, cell.traffic
        self.W, self.H = c["width"], c["height"]
        self.n = t["segment"]
        if self.n != c["idr_period"]:
            raise ValueError("a segment is one IDR period: the traffic's "
                             "segment must equal the configuration's "
                             "idr_period")
        self.chunks = [(a, min(a + t["chunk"], self.n))
                       for a in range(0, self.n, t["chunk"])]
        self.frames = None

    def settings(self) -> dict:
        """The configuration's encoder settings as ``CodecConfig`` keys."""
        c, e = self.cell.config, self.cell.config["encoder"]
        return {"fps": (1, c["fps"]), "gop_size": c["idr_period"],
                "qp": e["qp"], "me_range": e["me_range"],
                "deblock": e["deblock"], "slices": e["slices"],
                "temporal_layers": e["temporal_layers"]}

    def codec(self, **kw):
        from hartallo_tpu_torch import native
        from hartallo_tpu_torch.api import Codec, CodecConfig
        if not native.available():
            print("the port's native host library did not load: its "
                  "pure-Python paths run", file=sys.stderr)
        return Codec(CodecConfig(**kw), device=self.device)

    def make_clip(self):
        t = self.cell.traffic
        return make_segment(self.seed, self.W, self.H, self.n,
                            pan=tuple(t["pan_px_per_frame"]),
                            objects=[tuple(o) for o in t["objects"]],
                            noise=t["noise"], device=self.device)

    def sample_rng(self):
        return np.random.default_rng(abs(self.seed))

    def sample(self, first: dict) -> list:
        """The segment places the reference checks: every chunk's first
        picture (the IDR picture, and the pictures decoded from a
        previous call's state), then P pictures drawn from the seed at
        ``check_after`` or later."""
        t = self.cell.traffic
        want = t["check_pictures"]
        fixed = [a for a, _ in self.chunks if a in first][:want]
        rest = [k for k in sorted(first) if k not in fixed and
                k >= t.get("check_after", 1) and
                k % self.cell.config["idr_period"]]
        extra = self.sample_rng().choice(
            rest, size=min(len(rest), max(0, want - len(fixed))),
            replace=False) if rest else []
        return fixed + sorted(int(k) for k in extra)

    def pool(self, workers, stream: bytes):
        n = _workers(workers or self.cell.traffic["check_workers"])
        return _pool(n, max(1, (os.cpu_count() or 1) // n), stream)

    def window(self, seconds: float) -> Window:
        w = Window()
        before = self.counters()
        t0 = time.perf_counter()
        k = 0
        while True:
            a, b = self.chunks[k % len(self.chunks)]
            w.attempted += b - a
            tc = time.perf_counter()
            try:
                got = self.call(a, b)
            except Exception as e:                      # noqa: BLE001
                traceback.print_exc(file=sys.stderr)
                w.error = f"{type(e).__name__}: {e}"[:500]
                break
            w.call_s.append((a, time.perf_counter() - tc))
            w.outputs.append((a, got[:b - a]))
            w.completed += sum(o is not None for o in got[:b - a])
            w.idr_pictures += sum(1 for i in range(a, b)
                                  if i % self.cell.config["idr_period"] == 0)
            k += 1
            # whole segments only, so every run does the same mix of
            # pictures (the IDR picture's chunk costs more than the rest)
            if k % len(self.chunks) == 0 and \
                    time.perf_counter() - t0 >= seconds:
                break
        w.wall_s = time.perf_counter() - t0
        w.failed = w.attempted - w.completed
        w.rate = w.completed / w.wall_s if w.wall_s > 0 else 0.0
        after = self.counters()
        w.counters = {key: after[key] - before.get(key, 0) for key in after}
        return w

    def release(self):
        self.program = None
        gc.collect()
        if self.device != "cpu":
            import torch
            torch.cuda.empty_cache()

    @staticmethod
    def first_and_mismatch(w: Window, same):
        """Each segment index's first output in the window, and how many
        later outputs of an index differ from its first (``same``)."""
        first, mismatch = {}, []
        for a, outs in w.outputs:
            for i, o in enumerate(outs):
                if o is None:
                    continue
                if a + i not in first:
                    first[a + i] = o
                elif not same(first[a + i], o):
                    mismatch.append(a + i)
        if mismatch:
            print(f"outputs that differ from their index's first: "
                  f"{mismatch[:20]}", file=sys.stderr)
        return first, len(mismatch)

    def setup(self):
        self.frames = self.make_clip()
        enc = self.codec(width=self.W, height=self.H, **self.settings())
        coded = [r.headers + r.data
                 for r in enc.encode_frames(self.frames, self.W, self.H)]
        del enc
        self.stream = b"".join(coded)
        self.chunk_bytes = {a: b"".join(coded[a:b]) for a, b in self.chunks}
        self.program = self.codec()
        for a, b in self.chunks:                  # warm-up: one segment
            self.call(a, b)

    def call(self, a: int, b: int):
        res = self.program.decode_annexb(self.chunk_bytes[a], tolerant=False)
        return [r.frame for r in res]

    def counters(self) -> dict:
        return dict(self.program.decoder.stats)

    def check(self, w: Window, workers: int = None, control=False):
        from portbench.reference import check
        first, mismatch = self.first_and_mismatch(
            w, lambda x, y: x.shape == y.shape and np.array_equal(x, y))
        ks = self.sample(first)
        with self.pool(workers, self.stream) as pool:
            futs = [pool.submit(check.decode_chain, k, first.get(k - 2),
                                [first.get(k - 1), first[k]], control)
                    for k in ks]
            res = [f.result() for f in futs]
        for r in res:
            print(f"reference: pictures {r['pictures']} max |diff| "
                  f"{r['max_abs_diff']}"
                  + (f" control {r['control_max_abs_diff']}" if control
                     else "")
                  + (f" ({r['error']})" if "error" in r else "")
                  + f" ({r['seconds']:.1f} s)", file=sys.stderr)

        def checks(key):
            worst = max((max(r[key]) for r in res), default=256)
            return {"missing_frames": {"value": w.failed, "limit": 0},
                    "cycle_mismatch_frames": {"value": mismatch,
                                              "limit": 0},
                    "sample_max_abs_diff": {"value": worst, "limit": 0}}
        self.checked = res
        return checks("max_abs_diff"), \
            checks("control_max_abs_diff") if control else None
