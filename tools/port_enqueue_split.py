"""The 1080p host enqueue split into its two calls, ``mv.derive_mvs`` and
``d_pool.pack_fast``, over one benchmark cell's window.

    python3 tools/port_enqueue_split.py --workload dec-1080p-ingest \
        --seed 7 --seconds 30 [--packer native|py]

Runs the cell once through ``portbench.harness.run_cell(..., trace=False)``
with both calls timed (``time.perf_counter``) over the measured window
alone.  ``--packer py`` puts ``d_pool.pack_fast_py`` (the numpy body) in
the decoder's place for the run, so one host measures the payload pass
before and after.  Afterwards the first kernel-route IDR picture and two
P pictures of the window are packed again, ten times each, by the native
pass and by ``pack_fast_py`` on the same inputs.  Prints one JSON line:
``decode_fps``, ``correct``, the window's frames, ms a frame of each
call and the enqueue span (``hartallo_tpu_torch.tracing``), ms a call of
each packer on IDR and P pictures, and the same-input timings (minimum
and median ms).
"""
import argparse
import copy
import json
import os
import pathlib
import statistics
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def _timed(fn, into):
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            into.append(time.perf_counter() - t0)
    return wrapper


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--packer", choices=("native", "py"), default="native")
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    from hartallo_tpu_torch import tracing
    from hartallo_tpu_torch.decode import d_pool, mv
    from portbench import harness

    cell = harness.Cell.load(harness.load_spec(), args.workload)
    entry = harness.entry_class(cell.traffic)
    untraced, seen = entry.window, {}
    mv_s, pack_s, kinds, samples = [], [], [], []
    packer = d_pool.pack_fast if args.packer == "native" else \
        d_pool.pack_fast_py

    def pack(sd, *a, **kw):
        t0 = time.perf_counter()
        out = packer(sd, *a, **kw)
        pack_s.append(time.perf_counter() - t0)
        idr = out.ilist.shape[0] == sd.gw * sd.gh
        kinds.append("idr" if idr else "p")
        if len(samples) < 3 and idr == (not samples):   # an IDR, two P
            samples.append((copy.deepcopy(sd), copy.deepcopy(a),
                            copy.deepcopy(kw)))
        return out

    def window(self, seconds):
        mv.derive_mvs = _timed(orig_mvs, mv_s)
        d_pool.pack_fast = pack
        tracing.reset()
        tracing.enable()
        try:
            w = untraced(self, seconds)
        finally:
            tracing.enable(False)
            mv.derive_mvs, d_pool.pack_fast = orig_mvs, orig_pack
        seen.update(tracing.snapshot(), frames=w.completed, wall=w.wall_s)
        return w

    orig_mvs, orig_pack = mv.derive_mvs, d_pool.pack_fast
    d_pool.pack_fast = packer
    entry.window = window
    result = harness.run_cell(cell, args.seed, args.seconds, trace=False)
    d_pool.pack_fast = orig_pack
    n = seen["frames"]

    def per_kind(k):
        t = [s for s, c in zip(pack_s, kinds) if c == k]
        return round(statistics.median(t) * 1e3, 3) if t else None

    same_input = {}
    for i, (sd, a, kw) in enumerate(samples):
        name = "idr" if i == 0 else f"p{i}"
        for label, fn in (("native", d_pool.pack_fast),
                          ("py", d_pool.pack_fast_py)):
            t = []
            for _ in range(10):
                t0 = time.perf_counter()
                fn(sd, *a, **kw)
                t.append(time.perf_counter() - t0)
            same_input[f"{name}.{label}"] = [round(min(t) * 1e3, 3),
                                             round(statistics.median(t) * 1e3,
                                                   3)]
    enq = seen["spans"].get("decode.enqueue", {"seconds": 0.0})
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "packer": args.packer,
        "decode_fps": result["metrics"]["decode_fps"]["value"],
        "correct": result["correct"], "frames": n,
        "wall_ms_per_frame": round(seen["wall"] * 1e3 / n, 4),
        "enqueue_span_ms_per_frame": round(enq["seconds"] * 1e3 / n, 4),
        "derive_mvs_ms_per_frame": round(sum(mv_s) * 1e3 / n, 4),
        "pack_fast_ms_per_frame": round(sum(pack_s) * 1e3 / n, 4),
        "pack_fast_ms_per_call": {"idr": per_kind("idr"), "p": per_kind("p")},
        "calls": {"derive_mvs": len(mv_s), "pack_fast": len(pack_s)},
        "same_input_ms_min_median": same_input,
        "counters": seen["counters"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
