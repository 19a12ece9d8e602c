"""The program's own counters (``hartallo_tpu_torch.tracing.add``) for
the per-layer metrics that read them.

The tracer loads a metric's file after set-up, just before the window,
and ``run.py`` runs one cell a process, so a metric file takes its
baseline (``now()``) when it is loaded and reads the change over the
window (``change``) when the window has closed.  A program without the
counters gives None for both.
"""
from __future__ import annotations

try:
    from hartallo_tpu_torch import tracing as _tracing
except ImportError:            # a program from before its counters
    _tracing = None


def now():
    """The program's counters, or None where it has none."""
    return _tracing.snapshot()["counters"] if _tracing else None


def change(base, name: str):
    """The counter ``name``'s change since ``base`` (a ``now()``), or None
    where the program has no counters."""
    if base is None:
        return None
    return now().get(name, 0) - base.get(name, 0)


def gbps(base, name: str, trace, device_op: str):
    """The bytes the counter ``name`` added over the window, over the
    summed device time of ``device_op`` in the trace, in GB/s; None where
    either is nothing."""
    moved = change(base, name)
    seconds = trace.kernels.get(device_op, (0.0, 0))[0]
    if not moved or seconds <= 0:
        return None
    return moved / seconds / 1e9
