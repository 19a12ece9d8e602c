"""The decoder's deblock parameter CUDA kernel's own code, run on the CPU
under an emulation of the CUDA features it uses, against its plain twin.

``k_deblock_params_dec`` of ``csrc/deblock.cu`` (its source from the
deblock includes up to the C entry points, with ``deblock_params.cuh``
and ``NAUX`` in place of the wavefront's header) is compiled with g++ after
``tests/cuda_emulation.h`` (one ``std::thread`` per CUDA thread, the
width-16 shuffles, the blocks of the launch's grid one after another,
the picture index as ``blockIdx.z``) and launched with the C entry
point's grid and block.  This holds the kernel's indexing, the record's
field offsets, the wrap at the picture's edges, the per-MB offsets and
the bS rules against ``ops/deblock_fast.deblock_params_dec_plain`` on
every run where there is no card; nvcc's build and the card stay the
authority (the ``cuda`` tests of ``tests/test_torch_intra_decode.py`` and
``chip_smoke.py``).  Inputs: ``chip_smoke.deblock_rec_inputs`` at 1x1,
5x3, 7x1, 1x6 and 17x3 MBs (a strip of 8 MBs left part empty), one to
three pictures a launch, in the general route's record and in the GOP
scan's dense buffer, with slice-edge flags, nonzero per-MB offsets,
``fint`` false on some MBs, refIdx that differ across edges, and edge
flags on column 0 and row 0.  ``test_emulated_mutants_fail`` builds two
broken copies of the source (the internal edges gated by the MB edge
flags; the top neighbour read from the picture's first row instead of
the row above) and shows that each disagrees with the twin.  Tolerance:
exact equality.
"""
import ctypes
import os
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke as CS

TESTS = pathlib.Path(__file__).resolve().parent
REPO = TESTS.parent
SOURCE = REPO / "hartallo_tpu_torch" / "csrc" / "deblock.cu"
HARNESS = r"""
#include "cuda_emulation.h"
#include "deblock_params_body.inc"

extern "C" void emu_deblock_params_dec(const int32_t* rec, int words,
                                       const int* offs, const int32_t* tab,
                                       int16_t* aux, int K, int gw, int gh,
                                       int cqo) {
  const Fields f{offs[0], offs[1], offs[2], offs[3], offs[4],
                 offs[5], offs[6], offs[7], offs[8], offs[9]};
  const DdArgs a{rec, tab, aux, f, words, gw, gh, cqo};
  if (DD_SMEM_BYTES > (int)sizeof(smem)) std::abort();
  emu_launch_grid(k_deblock_params_dec, a, dd_strips(gw), gh, DD_THREADS,
                  K);
}
"""


def _build(text: str, tag: str):
    """The parameter kernel's code in ``text`` built with g++ under the
    emulation header into ``build/emulated/`` of the checkout; returns
    (the loaded library, its directory)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the emulated kernel")
    start = text.index('#include "deblock_wavefront.cuh"\n')
    body = text[start:text.index("// Plain C entry points")]
    body = body.replace('#include "deblock_wavefront.cuh"\n',
                        "namespace hl { constexpr int NAUX = 62; }\n")
    out = REPO / "build" / "emulated" / f"dp_{tag}_{os.getpid()}"
    out.mkdir(parents=True, exist_ok=True)
    (out / "deblock_params_body.inc").write_text(body)
    (out / "harness.cpp").write_text(HARNESS)
    lib = out / "libemu_deblock_params.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-w", "-shared", "-fPIC",
                    "-pthread", f"-I{TESTS}", f"-I{out}",
                    f"-I{SOURCE.parent}", "-o", str(lib),
                    str(out / "harness.cpp")],
                   check=True, capture_output=True, timeout=300)
    dll = ctypes.CDLL(str(lib))
    dll.emu_deblock_params_dec.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p] + [ctypes.c_int] * 4
    return dll, out


@pytest.fixture(scope="module")
def emulated():
    dll, out = _build(SOURCE.read_text(), "main")
    yield dll
    shutil.rmtree(out, ignore_errors=True)


def run(dll, rec, offsets, cqo, gw, gh):
    from hartallo_tpu_torch.ops import deblock_fast as D
    rec = np.ascontiguousarray(rec, np.int32)
    K = rec.shape[0]
    offs = (ctypes.c_int * len(offsets))(*offsets)
    tab = D._param_tables("cpu").numpy().copy()
    aux = np.full((K, gh, gw, D.NAUX), -1, np.int16)
    dll.emu_deblock_params_dec(rec.ctypes.data, rec.shape[2], offs,
                               tab.ctypes.data, aux.ctypes.data, K, gw, gh,
                               cqo)
    return aux


def twin(rec, offsets, cqo, gw, gh):
    from hartallo_tpu_torch.ops.deblock_fast import deblock_params_dec_plain
    return deblock_params_dec_plain(torch.tensor(rec), offsets, cqo, gw=gw,
                                    gh=gh).numpy()


CASES = [
    ("1x1", 1, 1, 1, {}),
    ("5x3, three pictures", 5, 3, 3, {}),
    ("7x1, one MB row", 7, 1, 2, {}),
    ("1x6, one MB column", 1, 6, 1, {}),
    ("17x3, a strip part empty", 17, 3, 2, {}),
    ("5x3, the GOP scan's dense buffer", 5, 3, 2, {"wide": True}),
    ("9x4, edge flags on column 0 and row 0", 9, 4, 2,
     {"edge_flags": True}),
]


@pytest.mark.parametrize("cqo", [0, -3, 5])
@pytest.mark.parametrize("label,gw,gh,K,opts", CASES,
                         ids=[c[0] for c in CASES])
def test_emulated_params_equal_twin(emulated, label, gw, gh, K, opts, cqo):
    rec, offs = CS.deblock_rec_inputs(gw, gh, K, 40 + gw * gh + cqo, **opts)
    np.testing.assert_array_equal(run(emulated, rec, offs, cqo, gw, gh),
                                  twin(rec, offs, cqo, gw, gh))


# (label, text replaced, its replacement)
MUTANTS = [
    ("internal edges gated by the MB edge flags", "(bx ? fi : fv)", "fv"),
    ("the top neighbour from row 0", "(my ? my - 1 : a.gh - 1) * gw",
     "0 * gw"),
]


@pytest.mark.parametrize("label,old,new", MUTANTS,
                         ids=[m[0] for m in MUTANTS])
def test_emulated_mutants_fail(label, old, new):
    text = SOURCE.read_text()
    assert text.count(old) == 1, old
    dll, out = _build(text.replace(old, new),
                      f"m{[m[0] for m in MUTANTS].index(label)}")
    try:
        gw, gh = 9, 4
        rec, offs = CS.deblock_rec_inputs(gw, gh, 2, 77, edge_flags=True)
        assert not np.array_equal(run(dll, rec, offs, 0, gw, gh),
                                  twin(rec, offs, 0, gw, gh)), \
            f"the mutant '{label}' went unnoticed"
    finally:
        shutil.rmtree(out, ignore_errors=True)
