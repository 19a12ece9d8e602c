"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Exits non-zero and prints no result where the card is missing, where
the cell asks for more cards than there are, or where ``jax``,
``jaxlib``, ``flax`` or ``hartallo_tpu`` is loaded once the window has
closed.  The last lines of standard error are the numbers compared with
their limits; the last line of standard output is the result.

This module imports only the standard library at its top: the
reference's worker processes are spawned, and each imports this file
again before it runs.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    # the library the port loads must not bring JAX along
    os.environ.setdefault("USE_FLAX", "0")
    from portbench import harness
    spec = harness.load_spec()
    cell = harness.Cell.load(spec, args.workload)

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2

    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
