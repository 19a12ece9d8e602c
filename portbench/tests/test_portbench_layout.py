"""Configurations, traffic mixes, per-layer metrics and kernel bounds are
files found by name: a later change adds a file and an entry and edits
no file that is there."""
import hashlib
import json
import shutil
import types

import pytest

from portbench import harness
from portbench.bounds import least_seconds


def _digest(root):
    return {p.relative_to(root): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and
            "__pycache__" not in p.parts}


def test_spec_cells_load_by_name():
    spec = harness.load_spec()
    for w in spec["workloads"]:
        cell = harness.Cell.load(spec, w["name"])
        assert cell.config["name"] == w["config"]
        assert harness.entry_class(cell.traffic) is not None
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(harness.metric_module(m["name"]).read)
            assert m["moves"] in names


def test_every_kernel_of_a_roofline_has_its_bound():
    spec = harness.load_spec()
    for m in spec["per_layer"]:
        mod = harness.metric_module(m["name"])
        for k in getattr(mod, "KERNELS", ()):
            assert harness.bound_module(k) is not None, k


def test_new_files_need_no_edit(tmp_path, monkeypatch):
    root = tmp_path / "portbench"
    shutil.copytree(harness.HERE, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(root)
    spec = harness.load_spec()
    conf = json.loads((harness.REPO / spec["configs"][0]["file"])
                      .read_text())
    conf["name"] = "new-config"
    (root / "configs" / "new-config.json").write_text(json.dumps(conf))
    traffic = json.loads((root / "traffic" / "decode-ingest.json")
                         .read_text())
    traffic["chunk"] = 10
    (root / "traffic" / "new-mix.json").write_text(json.dumps(traffic))
    (root / "layer_metrics" / "new_metric.decode.py").write_text(
        "KERNELS = ('k_new',)\n"
        "def read(trace):\n"
        "    return trace.roofline_pct(KERNELS)\n")
    (root / "bounds" / "k_new.py").write_text(
        "from portbench.bounds import seconds\n"
        "def least_seconds(trace):\n"
        "    return seconds(3.35e12 * 0.5)\n")
    spec["configs"].append({"name": "new-config", "source": "x",
                            "file": "portbench/configs/new-config.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "new-cell", "config": "new-config",
                              "traffic": "new-mix", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "new_metric.decode", "unit": "%",
                              "better": "higher", "source": "device_trace",
                              "layer": "x", "moves": "decode_fps",
                              "workloads": ["new-cell"]})
    spec["end_to_end"][0]["workloads"].append("new-cell")
    monkeypatch.setattr(harness, "HERE", root)
    monkeypatch.setattr(harness, "REPO", tmp_path)
    cell = harness.Cell.load(spec, "new-cell")
    assert cell.config["name"] == "new-config"
    assert cell.traffic["chunk"] == 10
    assert [m["name"] for m in cell.per_layer] == ["new_metric.decode"]
    mod = harness.metric_module("new_metric.decode")
    trace = types.SimpleNamespace(kernels={"k_new": (1.0, 3)})
    trace.roofline_pct = lambda ks: 100.0 * sum(
        least_seconds(k, trace) for k in ks) / sum(
        trace.kernels[k][0] for k in ks)
    assert mod.read(trace) == pytest.approx(50.0)
    after = _digest(root)
    assert {k: v for k, v in after.items() if k in before} == before
