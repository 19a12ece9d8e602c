"""The port's spans and counters (``hartallo_tpu_torch/tracing.py``) on
the decode path, on the CPU.

- The frames are the recorded bytes with tracing off, with ``enable()``
  and under a CPU-only ``torch.profiler``.
- Under the profiler, with the benchmark's wrappers installed
  (``portbench.tracing.Tracer`` of a decode cell), every label of
  ``decode/decoder.py`` appears, and no two collected ranges overlap
  except a program span around the wrapped call it mirrors
  (``decode.parse`` around ``parse``, ``decode.enqueue`` around
  ``enqueue``).  The cell's metrics read from that trace: each span
  metric a time, ``batch_pictures.decode`` the pictures over the
  batches, the copy rates nothing (no device copies on the CPU).
- ``decode.batches`` and ``decode.fetch_bytes`` equal the values computed
  from the fixture's pictures, their routes, ``batch_k`` and the frame
  size.
- With tracing off and no profiler running, the span table stays empty.

The fixtures: ``qcif_6`` (every picture on the GOP kernel's route) and
``qcif_6_wp`` (its IDR picture on the kernel's route, its five weighted P
pictures on the GOP scan).
"""
import sys
import time
import types

import pytest
import torch

from _torch_port import load_fixture
from hartallo_tpu_torch import tracing
from hartallo_tpu_torch.decode.decoder import Decoder
from hartallo_tpu_torch.util.checks import plane_md5

LABELS = ("decode.nal", "decode.parse", "decode.prepare", "decode.enqueue",
          "decode.upload", "decode.launch", "decode.fetch", "decode.output")
# program span -> the benchmark's wrapper label it mirrors
MIRRORS = {"decode.parse": "parse", "decode.enqueue": "enqueue"}
# each fixture's routes in decode order
ROUTES = {"qcif_6": "kkkkkk", "qcif_6_wp": "ksssss"}


@pytest.fixture(autouse=True)
def _table_off():
    tracing.enable(False)
    tracing.reset()
    yield
    tracing.enable(False)
    tracing.reset()


def _decode(stream, batch_k=16):
    dec = Decoder(device="cpu", batch_k=batch_k)
    return dec.decode_annexb(stream, tolerant=False), dec


def _expected_batches(routes: str, batch_k: int) -> int:
    """A batch of ``batch_k`` queued pictures launches one run for each
    stretch of consecutive pictures of one route."""
    n = 0
    for i in range(0, len(routes), batch_k):
        chunk = routes[i:i + batch_k]
        n += 1 + sum(a != b for a, b in zip(chunk, chunk[1:]))
    return n


@pytest.mark.parametrize("mode", ["off", "enabled", "profiler"])
@pytest.mark.parametrize("name", sorted(ROUTES))
def test_frames_equal_with_tracing(name, mode):
    stream, meta = load_fixture(name)
    if mode == "enabled":
        tracing.enable()
    if mode == "profiler":
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            out, _ = _decode(stream)
    else:
        out, _ = _decode(stream)
    assert [plane_md5(r.frame) for r in out] == meta["frame_md5"]
    spans = tracing.snapshot()["spans"]
    if mode == "enabled":
        assert set(spans) == set(LABELS)
        assert all(s["count"] > 0 and s["seconds"] > 0
                   for s in spans.values())
    else:
        assert spans == {}


def _fresh_tracer(cell):
    """A tracer whose metric files are loaded now (a counter metric takes
    its baseline when its file is loaded)."""
    from portbench import tracing as bench_tracing
    for key, mod in list(sys.modules.items()):
        if "layer_metrics" in (getattr(mod, "__file__", None) or ""):
            del sys.modules[key]
    return bench_tracing.Tracer(cell, on_cuda=False)


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_spans_are_leaves_under_the_profiler(name):
    from portbench import harness
    stream, meta = load_fixture(name)
    cell = harness.Cell.load(harness.load_spec(), "dec-1080p-ingest")
    tracer = _fresh_tracer(cell)
    tracer.install()
    try:
        tracer.start()
        t0 = time.perf_counter()
        out, dec = _decode(stream)
        wall = time.perf_counter() - t0
        tracer.stop()
    finally:
        tracer.uninstall()
    assert [plane_md5(r.frame) for r in out] == meta["frame_md5"]
    cpu, _ = tracer._events()
    assert set(LABELS) <= {n for n, _, _ in cpu}
    assert all(b >= a for _, a, b in cpu)
    ranges = sorted(cpu, key=lambda e: (e[1], -e[2]))
    for i, (n1, a1, b1) in enumerate(ranges):
        for n2, a2, b2 in ranges[i + 1:]:
            if a2 >= b1:
                break
            # the only overlap: a wrapped call inside the span mirroring it
            assert MIRRORS.get(n1) == n2 and a1 <= a2 and b2 <= b1, \
                (n1, a1, b1, n2, a2, b2)
    for wrapped in MIRRORS.values():
        calls = [(a, b) for n, a, b in cpu if n == wrapped]
        assert calls
        outer = [e for e in cpu if MIRRORS.get(e[0]) == wrapped]
        assert all(any(a1 <= a and b <= b1 for _, a1, b1 in outer)
                   for a, b in calls)

    window = types.SimpleNamespace(completed=len(out), wall_s=wall,
                                   counters=dict(dec.stats))
    metrics, _, _ = tracer.metrics(window)
    for m in ("nal_ms.decode", "parse_span_ms.decode", "prepare_ms.decode",
              "enqueue_span_ms.decode", "upload_ms.decode",
              "launch_ms.decode", "fetch_ms.decode", "output_ms.decode"):
        assert metrics[m]["value"] > 0, m
    assert metrics["batch_pictures.decode"]["value"] == \
        len(out) / _expected_batches(ROUTES[name], 16)
    assert "fetch_gbps.decode" not in metrics
    assert "upload_gbps.decode" not in metrics


@pytest.mark.parametrize("batch_k", [1, 4, 16])
@pytest.mark.parametrize("name", sorted(ROUTES))
def test_counters_follow_the_batches(name, batch_k):
    stream, meta = load_fixture(name)
    routes = ROUTES[name]
    before = tracing.snapshot()["counters"]
    out, dec = _decode(stream, batch_k)
    after = tracing.snapshot()["counters"]
    assert dec.stats == {"kernel_pictures": routes.count("k"),
                         "scan_pictures": routes.count("s"),
                         "general_pictures": 0}

    def change(key):
        return after.get(key, 0) - before.get(key, 0)
    assert change("decode.batches") == _expected_batches(routes, batch_k)
    frame_bytes = meta["width"] * meta["height"] * 3 // 2
    assert change("decode.fetch_bytes") == len(out) * frame_bytes == \
        sum(r.frame.nbytes for r in out)
    assert change("decode.upload_bytes") > 0
    assert tracing.snapshot()["spans"] == {}
