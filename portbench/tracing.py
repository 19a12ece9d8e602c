"""The traced run: spans around the program's functions, the device trace,
and the per-layer metrics read from them.

A per-layer metric file (``layer_metrics/<name>.py``) may declare

- ``LABEL`` and ``WRAP``: the span label and the program's functions
  (``"module:Attr.path"``) to time under it.  Each call runs inside
  ``torch.profiler.record_function(LABEL)``, so the span and the device's
  operations share the profiler's clock; nothing synchronizes;
- ``HOOKS``: ``{"module:Attr.path": fn}``; ``fn(args, kwargs, result,
  pictures)`` runs after each call, outside the span, and records what a
  bound needs in ``pictures`` (a list shared by the run);
- ``read(trace)``: the metric's value from a ``Trace``, or None where the
  run gave it nothing to read (a wrapped function that the program no
  longer has, a kernel that never ran).

A function that the program no longer has is skipped, and the metrics
that time it read None.
"""
from __future__ import annotations

import bisect
import importlib
import re
import subprocess
import sys

from portbench import harness

_KERNEL_NAME = re.compile(r"^(?:\w+::)*([A-Za-z_]\w*)")
DEVICE_OPS_KEPT = 10


def kernel_base(name: str) -> str:
    """A device operation's short name: ``void (anonymous
    namespace)::k_mc_dec<unsigned char>(McArgs<unsigned char>)`` ->
    ``k_mc_dec``; ``Memcpy HtoD (Pinned -> Device)`` -> ``Memcpy HtoD``."""
    name = name.strip()
    if name.startswith(("Memcpy", "Memset")):
        return name.split(" (")[0]
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    m = _KERNEL_NAME.match(name)
    return m.group(1) if m else name


def _resolve(target: str):
    mod_name, path = target.split(":")
    obj = importlib.import_module(mod_name)
    parts = path.split(".")
    for p in parts[:-1]:
        obj = getattr(obj, p)
    return obj, parts[-1]


class Trace:
    """What a traced window gave: spans by label (seconds, the union of
    each label's intervals), device kernels by base name (seconds,
    launches), the busy and window seconds, the pictures the hooks
    recorded, the window's counters and frames."""

    def __init__(self, cell, window, spans, kernels, busy_s, window_s,
                 pictures):
        self.cell = cell
        self.config = cell.config
        self.window = window
        self.frames = window.completed
        self.counters = window.counters
        self.spans = spans
        self.kernels = kernels
        self.busy_s = busy_s
        self.window_s = window_s
        self.pictures = pictures

    def span_ms_per_frame(self, label: str):
        if label not in self.spans or not self.frames:
            return None
        return self.spans[label] * 1e3 / self.frames

    def roofline_pct(self, kernels) -> float | None:
        """100 x the least time of the named kernels' work on the window's
        pictures (each kernel's ``bounds/<kernel>.py``, summed over the
        pictures it ran on) over their summed device time; None where
        none of them ran."""
        from portbench.bounds import least_seconds
        ran = [k for k in kernels if k in self.kernels]
        device_s = sum(self.kernels[k][0] for k in ran)
        if not ran or device_s <= 0:
            return None
        least = sum(least_seconds(k, self) for k in ran)
        return 100.0 * least / device_s


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60).stdout.split()
        return float(out[0]) if out else None
    except (OSError, subprocess.SubprocessError, ValueError):
        return None


def _union(intervals):
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


class Tracer:
    def __init__(self, cell, on_cuda: bool):
        self.cell = cell
        self.on_cuda = on_cuda
        self.mods = {m["name"]: harness.metric_module(m["name"])
                     for m in cell.per_layer}
        self.pictures = []
        self.saved = []
        self.prof = None

    # -- spans ----------------------------------------------------------
    def install(self):
        import torch
        targets = {}
        for mod in self.mods.values():
            for t in getattr(mod, "WRAP", ()):
                targets.setdefault(t, [None, []])[0] = mod.LABEL
            for t, fn in getattr(mod, "HOOKS", {}).items():
                hooks = targets.setdefault(t, [None, []])[1]
                if fn not in hooks:
                    hooks.append(fn)
        for target, (label, hooks) in targets.items():
            try:
                owner, attr = _resolve(target)
                orig = getattr(owner, attr)
            except (ImportError, AttributeError):
                continue                 # renamed: its metrics read None
            self.saved.append((owner, attr, orig))
            setattr(owner, attr, self._wrapper(orig, label, hooks, torch))

    def _wrapper(self, orig, label, hooks, torch):
        pictures = self.pictures

        def wrapped(*args, **kwargs):
            if label is None:
                result = orig(*args, **kwargs)
            else:
                with torch.profiler.record_function(label):
                    result = orig(*args, **kwargs)
            for fn in hooks:
                fn(args, kwargs, result, pictures)
            return result
        return wrapped

    def uninstall(self):
        for owner, attr, orig in reversed(self.saved):
            setattr(owner, attr, orig)
        self.saved = []

    # -- the profiler ---------------------------------------------------
    def start(self):
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.on_cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.pictures.clear()
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()

    def stop(self):
        if self.on_cuda:
            import torch
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    def _events(self):
        """(cpu annotations [(label, start, end)], device ops [(name,
        start, end)]) in seconds on the profiler's clock."""
        labels = {getattr(m, "LABEL", None) for m in self.mods.values()}
        labels.discard(None)
        cpu, dev = [], []
        for e in self.prof.profiler.kineto_results.events():
            if hasattr(e, "start_ns"):
                a, b = e.start_ns() * 1e-9, e.end_ns() * 1e-9
            else:
                a, b = e.start_us() * 1e-6, \
                    (e.start_us() + e.duration_us()) * 1e-6
            kind = str(e.device_type())
            if kind.endswith("CPU"):
                if e.name() in labels:
                    cpu.append((e.name(), a, b))
            elif b > a and e.name() not in labels:
                # (a span's mirror on the device's timeline is no work)
                dev.append((e.name(), a, b))
        return cpu, dev

    def metrics(self, window):
        cpu, dev = self._events()
        spans = {}
        for label in {c[0] for c in cpu}:
            spans[label] = _union([(a, b) for n, a, b in cpu if n == label])
        kernels = {}
        for name, a, b in dev:
            k = kernel_base(name)
            s, n = kernels.get(k, (0.0, 0))
            kernels[k] = (s + (b - a), n + 1)
        busy = _union([(a, b) for _, a, b in dev])
        for k, (sec, n) in sorted(kernels.items(), key=lambda x: -x[1][0]):
            print(f"device op {k}: {n} x, {sec * 1e3:.3f} ms", file=sys.stderr)
        # the traced window: from the first to the last of the window's
        # calls, as the entry timed them on the profiler's clock
        window_s = window.wall_s
        limit = power_limit_w() if self.on_cuda else None
        trace = Trace(self.cell, window, spans, kernels, busy, window_s,
                      self.pictures)
        out = {}
        for m in self.cell.per_layer:
            v = self.mods[m["name"]].read(trace)
            if v is not None:
                out[m["name"]] = {"value": v, "unit": m["unit"]}
        extra = {"busy_s": busy, "window_s": window_s}
        if limit is not None:
            extra["power_limit_w"] = limit
        return out, extra, self._breakdown(cpu, dev, kernels)

    def _breakdown(self, cpu, dev, kernels):
        ops = sorted(((k, s) for k, (s, _) in kernels.items()),
                     key=lambda x: -x[1])[:DEVICE_OPS_KEPT]
        # idle gaps between device operations, each put down to the
        # wrapped host layer running at its middle ("host other" where
        # none was)
        iv = sorted((a, b) for _, a, b in dev)
        gaps = []
        end = None
        for a, b in iv:
            if end is not None and a > end:
                gaps.append((end, a))
            end = b if end is None else max(end, b)
        spans = sorted((a, b, n) for n, a, b in cpu)
        starts = [s[0] for s in spans]
        by_label = {}
        for a, b in gaps:
            mid = (a + b) / 2
            label = "host other"
            # the latest span that starts before the middle and covers it
            # (the wrapped layers do not nest)
            i = bisect.bisect_right(starts, mid) - 1
            if i >= 0 and spans[i][1] >= mid:
                label = spans[i][2]
            by_label[label] = by_label.get(label, 0.0) + (b - a)
        idle = sorted(by_label.items(), key=lambda x: -x[1])
        return {"device_ops": [[k, s] for k, s in ops],
                "idle_gaps": [[k, s] for k, s in idle[:DEVICE_OPS_KEPT]]}
