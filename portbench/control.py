"""The readings that a cell's limits are set from: the program's and the
control's, on several seeds, in one process.

    python3 portbench/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

For each seed it sets the cell up, drives a short window at the cell's
own load, and runs the check twice (``harness.control_run``): on the
program's outputs, and with the control in the program's place (the
reference computed with the error that a faster program might be
tempted by: the decode cells' luma half-pel j filtered from 8-bit b
samples, ``reference.decode.luma_mc_blocks_8bit_j``), each judged by
the run's own ``harness.verdict``.  One JSON line a seed.  The
benchmark's own runs do not run the control.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.Cell.load(harness.load_spec(), args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        out = harness.control_run(cell, seed, args.seconds)
        out.update(workload=args.workload,
                   seconds=time.perf_counter() - t)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
