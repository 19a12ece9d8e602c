"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names, and the reference imports nothing of the
program."""
import ast
import subprocess
import sys
import types

from portbench import harness


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "hartallo_tpu_torch_fake_probe",
                        types.ModuleType("x"))
    assert "hartallo_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "hartallo_tpu.api",
                        types.ModuleType("hartallo_tpu.api"))
    assert "hartallo_tpu" in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert {"hartallo_tpu", "jaxlib"} <= set(harness.forbidden_modules())


def _imports(path):
    tree = ast.parse(path.read_text())
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            yield from (a.name for a in n.names)
        elif isinstance(n, ast.ImportFrom) and n.module and not n.level:
            yield n.module


def test_sources_import_no_jax():
    for p in harness.HERE.rglob("*.py"):
        for m in _imports(p):
            assert m.split(".")[0] not in harness.FORBIDDEN, (p, m)


def test_reference_sources_import_nothing_of_the_program():
    for p in (harness.HERE / "reference").rglob("*.py"):
        for m in _imports(p):
            assert m.split(".")[0] != "hartallo_tpu_torch", (p, m)


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import portbench.reference.check, "
            "portbench.reference.decode; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         cwd=harness.REPO).stdout.split()
    assert "hartallo_tpu_torch" not in out
    assert not set(out) & set(harness.FORBIDDEN)
