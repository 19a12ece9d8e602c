"""The port's host modules are its own copies of the JAX package's, and the
port imports nothing of the JAX package.

- An AST scan of every module under ``hartallo_tpu_torch/`` and of
  ``chip_smoke.py``: none imports ``hartallo_tpu``, ``jax`` or ``jaxlib``
  (at module level or inside a function).
- One case per copied module: its text equals the original's once the
  import lines are rewritten from ``hartallo_tpu`` to
  ``hartallo_tpu_torch``, and ``slicec.c`` is byte-equal.  The stated
  exception is ``native/__init__.py``, which builds its library under
  ``build/native/`` of the checkout, atomically, instead of next to its
  source (``NATIVE_EDITS``).
- The port's ``api.py`` holds the JAX package's ``CodecConfig``,
  ``DecodeResult`` and ``EncodeResult`` source for source.
- The numpy functions and tables copied into a port module whose
  original imports jax (``svc/upsample.py``, ``parallel/shard.py``'s
  GOP cutter) or that the port extends (``decode/d_pool.py``'s SVC
  residual helpers) equal the originals source for source, import lines
  rewritten (``PART_COPIES``).
"""
import ast
import pathlib
import re

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
SRC = REPO / "hartallo_tpu"
DST = REPO / "hartallo_tpu_torch"

COPIES = ["core/__init__.py", "core/tables.py",
          "bitio/__init__.py", "bitio/annexb.py", "bitio/reader.py",
          "bitio/writer.py",
          "entropy/__init__.py", "entropy/cavlc.py",
          "entropy/cavlc_tables.py",
          *(f"decode/{m}.py" for m in ("nal", "params", "sliceheader",
                                       "slice_decode", "mv", "poc", "dpb",
                                       "fmo")),
          "encode/ratecontrol.py", "encode/slice_encode.py",
          "util/__init__.py", "util/log.py", "util/checks.py",
          "svc/__init__.py", "svc/motion.py",
          "native/__init__.py", "native/slicec.c"]

_IMPORT = re.compile(r"^(\s*(?:from|import)\s+)hartallo_tpu\b(?!_torch)",
                     re.M)

# (original text, the port's text) in native/__init__.py
NATIVE_EDITS = [
    ("(cached next to the source).  Falls back silently — callers check\n"
     "``available()``",
     "(cached in ``build/native/`` of the checkout).  Falls back silently "
     "—\ncallers check ``available()``"),
    ("import ctypes\nimport pathlib\n", "import ctypes\nimport os\n"
     "import pathlib\n"),
    ('_SO = _DIR / "slicec.so"\n',
     '_SO = _DIR.parent.parent / "build" / "native" / "slicec.so"\n'),
    ('    try:\n'
     '        subprocess.run(["gcc", "-O3", "-shared", "-fPIC", "-o",\n'
     '                        str(_SO), str(_SRC)],\n'
     '                       check=True, capture_output=True, timeout=300)\n'
     '        return True\n',
     '    try:\n'
     '        _SO.parent.mkdir(parents=True, exist_ok=True)\n'
     '        tmp = _SO.with_name(f"{_SO.name}.{os.getpid()}.tmp")\n'
     '        subprocess.run(["gcc", "-O3", "-shared", "-fPIC", "-o",\n'
     '                        str(tmp), str(_SRC)],\n'
     '                       check=True, capture_output=True, timeout=300)\n'
     '        os.replace(tmp, _SO)\n'
     '        return True\n'),
]


def rewrite_imports(text: str) -> str:
    """The rewrite a copy went through: hartallo_tpu -> hartallo_tpu_torch
    in the module path of every import line."""
    return _IMPORT.sub(r"\1hartallo_tpu_torch", text)


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_nothing_of_the_jax_package():
    files = sorted(DST.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 40
    bad = [(str(f.relative_to(REPO)), mod) for f in files
           for mod in _imported(ast.parse(f.read_text()))
           if mod.split(".")[0] in ("hartallo_tpu", "jax", "jaxlib")]
    assert not bad


@pytest.mark.parametrize("rel", COPIES)
def test_host_copy_equals_original(rel):
    if rel.endswith(".c"):
        assert (DST / rel).read_bytes() == (SRC / rel).read_bytes()
        return
    want = rewrite_imports((SRC / rel).read_text())
    if rel == "native/__init__.py":
        for old, new in NATIVE_EDITS:
            assert want.count(old) == 1, old
            want = want.replace(old, new)
    assert (DST / rel).read_text() == want


# module -> the top-level functions and tables copied from the original
PART_COPIES = {
    "decode/d_pool.py": ("accumulated_residual_planes_np",
                         "residual_planes_np"),
    "parallel/shard.py": ("_first_mb_is_zero", "split_gops"),
    "svc/upsample.py": ("PHASE_LUMA", "PHASE_CHROMA", "ref_positions",
                        "upsample_plane_np", "upsample_residual_plane_np",
                        "downsample_dyadic_np"),
}


def _top_level(path, names):
    """Source of each top-level def or assignment of ``names``."""
    text = path.read_text()
    out = {}
    for n in ast.parse(text).body:
        if isinstance(n, ast.FunctionDef):
            key = n.name
        elif isinstance(n, ast.Assign) and len(n.targets) == 1 and \
                isinstance(n.targets[0], ast.Name):
            key = n.targets[0].id
        else:
            continue
        if key in names:
            out[key] = ast.get_source_segment(text, n)
    return out


@pytest.mark.parametrize("rel", sorted(PART_COPIES))
def test_part_copy_equals_original(rel):
    names = PART_COPIES[rel]
    want = {k: rewrite_imports(v)
            for k, v in _top_level(SRC / rel, names).items()}
    assert sorted(want) == sorted(names)
    assert _top_level(DST / rel, names) == want


def test_api_dataclasses_equal_original():
    def classes(path):
        text = path.read_text()
        return {n.name: ast.get_source_segment(text, n)
                for n in ast.parse(text).body if isinstance(n, ast.ClassDef)
                and n.name in ("CodecConfig", "DecodeResult", "EncodeResult")}
    want = classes(SRC / "api.py")
    assert len(want) == 3
    assert classes(DST / "api.py") == want
