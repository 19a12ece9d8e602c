"""Spans and counters of the port's decode path.

A span names one host phase of a call:

    with tracing.span("decode.fetch"):
        host = dev.cpu().numpy()

- While ``torch.profiler`` is running, a span is a
  ``torch.profiler.record_function`` range of its name, on the
  profiler's clock, the clock of the device trace.
- After ``enable()``, a span also adds its count and its
  ``time.perf_counter_ns`` duration to a process-wide table.
- With neither, ``span`` returns one shared object that does nothing
  (a fraction of a microsecond a span).

A counter (``add(name, n)``) is a process-wide integer, always on; the
decoder adds to one once a batch, a fetch or a packed picture, never per
macroblock.

Operators read the table without a profiler:

    from hartallo_tpu_torch import tracing
    tracing.reset(); tracing.enable()
    frames = codec.decode_annexb(stream)
    tracing.snapshot()
    # {"spans": {"decode.parse": {"count": 12, "seconds": 0.041}, ...},
    #  "counters": {"decode.batches": 1, "decode.fetch_bytes": ..., ...}}

``tools/port_spans.py`` does this for a benchmark cell.  The decoder's
labels and counters are listed in ``decode/decoder.py``'s docstring.
Spans are leaves: none of the decoder's encloses another.

The table is not locked: the decoder runs on one thread, and a program
that decodes on several threads reads sums that may miss some updates.
"""
from __future__ import annotations

import contextlib
import time

import torch

_profiling = torch._C._autograd._profiler_enabled
_record_function = torch.profiler.record_function
_clock = time.perf_counter_ns

_enabled = False
_spans = {}          # name -> [count, nanoseconds]
_counters = {}       # name -> int
_NOOP = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "rf", "t0")

    def __init__(self, name: str):
        self.name = name
        self.rf = None
        self.t0 = None

    def __enter__(self):
        if _profiling():
            self.rf = _record_function(self.name)
            self.rf.__enter__()
        if _enabled:
            self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        if self.t0 is not None:
            dt = _clock() - self.t0
            s = _spans.get(self.name)
            if s is None:
                _spans[self.name] = [1, dt]
            else:
                s[0] += 1
                s[1] += dt
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager that times the block under ``name`` where the
    profiler runs or ``enable()`` was called, and does nothing else."""
    if _enabled or _profiling():
        return _Span(name)
    return _NOOP


def add(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _counters[name] = _counters.get(name, 0) + int(n)


def enable(on: bool = True) -> None:
    """Time spans into the table (``on``), or stop timing them."""
    global _enabled
    _enabled = bool(on)


def snapshot() -> dict:
    """A copy of the table: ``{"spans": {name: {"count", "seconds"}},
    "counters": {name: n}}``."""
    return {"spans": {k: {"count": c, "seconds": ns * 1e-9}
                      for k, (c, ns) in _spans.items()},
            "counters": dict(_counters)}


def reset() -> None:
    """Empty the span table and set every counter to nothing."""
    _spans.clear()
    _counters.clear()
