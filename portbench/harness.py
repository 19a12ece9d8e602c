"""The benchmark's general machinery: one run of one cell.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own, found by the name that
``BENCHMARK.json`` gives:

- ``configs/<config>.json``: the deployment (the cell's ``config`` entry
  names the file);
- ``traffic/<mix>.json``: the mix's parameters; its ``entry`` names the
  entry in ``entries.py`` that sets the mix up, drives the window and
  checks the outputs;
- ``layer_metrics/<metric>.py``: what a per-layer metric reads from a
  traced run (``WRAP``: the program's functions it times, ``HOOKS``: what
  it records after a call, ``read``: the number, or None);
- ``bounds/<kernel>.py``: the least bytes and operations of one device
  kernel's work on one picture, which the roofline metrics sum.

The program under test is ``hartallo_tpu_torch``; nothing here imports
``jax``, ``jaxlib``, ``flax`` or ``hartallo_tpu``.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "hartallo_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``hartallo_tpu_torch`` is not ``hartallo_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def load_spec(path=None) -> dict:
    return json.loads(pathlib.Path(path or REPO / "BENCHMARK.json")
                      .read_text())


def load_json(rel: str) -> dict:
    return json.loads((REPO / rel).read_text())


def load_file_module(path: pathlib.Path):
    """Import a file by path (metric files carry dots in their names)."""
    name = "portbench_file_" + "".join(
        c if c.isalnum() else "_" for c in str(path.relative_to(HERE)))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One cell: its spec entry, configuration, traffic and metrics."""

    def __init__(self, entry: dict, config: dict, traffic: dict,
                 end_to_end: list, per_layer: list):
        self.entry = entry
        self.name = entry["name"]
        self.chips = int(entry["chips"])
        self.config = config
        self.traffic = traffic
        self.end_to_end = end_to_end
        self.per_layer = per_layer

    @classmethod
    def load(cls, spec: dict, name: str) -> "Cell":
        """The cell ``name`` of the spec, its files found by their names."""
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
        entry = cells[name]
        conf = {c["name"]: c for c in spec["configs"]}[entry["config"]]
        traffic = json.loads(
            (HERE / "traffic" / f"{entry['traffic']}.json").read_text())

        def mine(m):
            return name in m.get("workloads", [name])
        return cls(entry, load_json(conf["file"]), traffic,
                   [m for m in spec["end_to_end"] if mine(m)],
                   [m for m in spec["per_layer"] if mine(m)])


def metric_module(name: str):
    return load_file_module(HERE / "layer_metrics" / f"{name}.py")


def bound_module(kernel: str):
    path = HERE / "bounds" / f"{kernel}.py"
    return load_file_module(path) if path.exists() else None


def entry_class(traffic: dict):
    from portbench import entries
    return getattr(entries, traffic["entry"])


def verdict(checks: dict, window) -> bool:
    """``correct``: every number compared within its limit, and a window
    whose calls all returned."""
    return all(c["value"] <= c["limit"] for c in checks.values()) and \
        window.error is None


def control_run(cell: Cell, seed: int, seconds: float,
                device: str = "cuda", workers: int = None) -> dict:
    """The readings a cell's limits are set from, for one seed: set-up,
    a short window at the cell's own load, then the check twice over,
    once on the program's outputs and once with the control's in their
    place, each judged by ``verdict`` as a run is."""
    entry = entry_class(cell.traffic)(cell, seed, device)
    entry.setup()
    window = entry.window(seconds)
    entry.release()
    checks, control = entry.check(window, workers=workers, control=True)
    return {"seed": seed, "checks": checks,
            "correct": verdict(checks, window), "control": control,
            "control_correct": verdict(control, window),
            "pictures": entry.checked}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = None,
             workers: int = None) -> dict:
    """One run: set-up, the measured window, the check.  Returns the
    result line's object (``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, maybe ``breakdown``, and ``checks`` last)."""
    import torch
    from portbench import tracing

    t_start = time.perf_counter() if t_start is None else t_start
    entry = entry_class(cell.traffic)(cell, seed, device)
    entry.setup()
    on_cuda = torch.device(device).type == "cuda"
    if on_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # the window starts from the same heap in every run
    gc.collect()
    tracer = tracing.Tracer(cell, on_cuda) if trace else None
    if tracer:
        tracer.install()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    try:
        if tracer:
            tracer.start()
        window = entry.window(seconds)
        if tracer:
            tracer.stop()
    finally:
        if tracer:
            tracer.uninstall()
    print("calls (first picture, s): " + " ".join(
        f"{a}:{t:.3f}" for a, t in window.call_s), file=sys.stderr)
    memory_peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    device_info = {"platform": "gpu" if on_cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_cuda
                   else "cpu",
                   "count": cell.chips if on_cuda else 0,
                   "memory_peak_bytes": int(memory_peak)}
    entry.release()
    checks, _ = entry.check(window, workers=workers)
    correct = verdict(checks, window)
    if trace:
        metrics, extra, breakdown = tracer.metrics(window)
        device_info.update(extra)
    else:
        metrics = {}
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
            else:
                metrics[m["name"]] = {"value": window.rate,
                                      "unit": m["unit"]}
        breakdown = None
    result = {"correct": bool(correct), "attempted": window.attempted,
              "failed": window.failed, "metrics": metrics,
              "device": device_info}
    if breakdown:
        result["breakdown"] = breakdown
    if window.error:
        result["error"] = window.error
    result["checks"] = checks
    return result
