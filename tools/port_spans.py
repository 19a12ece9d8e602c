"""The decoder's own spans over one benchmark cell's window, without the
profiler.

    python3 tools/port_spans.py --workload dec-1080p-ingest --seed 7 \
        --seconds 30

Runs the cell once through ``portbench.harness.run_cell(..., trace=False)``
with ``hartallo_tpu_torch.tracing`` enabled over the measured window alone
(set-up and the check untimed) and prints one JSON line: ``decode_fps``,
``correct``, the window's frames and wall time a frame, each span's ms and
count a frame, the spans' sum and its share of the wall time, and the
counters over the window.
"""
import argparse
import json
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    from hartallo_tpu_torch import tracing
    from portbench import harness

    cell = harness.Cell.load(harness.load_spec(), args.workload)
    entry = harness.entry_class(cell.traffic)
    untraced, seen = entry.window, {}

    def window(self, seconds):
        tracing.reset()
        tracing.enable()
        try:
            w = untraced(self, seconds)
        finally:
            tracing.enable(False)
        seen.update(tracing.snapshot(), frames=w.completed, wall=w.wall_s)
        return w

    entry.window = window
    result = harness.run_cell(cell, args.seed, args.seconds, trace=False)
    n = seen["frames"]
    spans = {k: round(v["seconds"] * 1e3 / n, 4)
             for k, v in sorted(seen["spans"].items())}
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "decode_fps": result["metrics"]["decode_fps"]["value"],
        "correct": result["correct"], "frames": n,
        "wall_ms_per_frame": round(seen["wall"] * 1e3 / n, 4),
        "spans_ms_per_frame": spans,
        "spans_sum_ms_per_frame": round(sum(spans.values()), 4),
        "spans_share_of_wall": round(sum(v["seconds"] for v in
                                         seen["spans"].values()) /
                                     seen["wall"], 4),
        "span_counts_per_frame": {k: round(v["count"] / n, 3) for k, v in
                                  sorted(seen["spans"].items())},
        "counters": seen["counters"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
