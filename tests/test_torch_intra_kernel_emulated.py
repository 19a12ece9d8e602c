"""The intra encode CUDA kernel's own code, run on the CPU under an
emulation of the CUDA features it uses, against its plain twin.

``csrc/intra_encode.cu`` up to its C entry point is compiled with g++
after ``tests/cuda_emulation.h`` and launched as the wrapper launches it:
one block of ``intra_encode_fast.THREADS`` per MB row, every row's block
at once (one ``std::thread`` per CUDA thread, barriers for
``__syncthreads`` and ``__syncwarp``, the rows' progress counters on
``std::atomic_ref`` with acquire loads and release stores, a yielding
spin-wait).  The rows run as freely as on the card, so a row that reads
its neighbours before they are published reads zeros or stale values.
This holds the kernel's indexing, lane mapping, costs, the Intra4x4
warps' steps, the four warps' join and the rows' waits against the twin
on every run where there is no card; nvcc's build and the card stay the
authority (the ``cuda`` tests and ``chip_smoke.py``).  Inputs:
``intra_case`` of
``tests/_torch_port.py``, among them a picture taller than wide and one
whose texture runs along the anti-diagonals, so that the Intra4x4 blocks
predict from their top-right neighbours.  Tolerance: exact equality of
every output.
"""
import ctypes
import os
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from _torch_port import intra_case

TESTS = pathlib.Path(__file__).resolve().parent
REPO = TESTS.parent
SOURCE = REPO / "hartallo_tpu_torch" / "csrc" / "intra_encode.cu"
HARNESS = r"""
#include "cuda_emulation.h"
#include "intra_encode_body.inc"

extern "C" int emu_intra_encode_frame(
    const int32_t* sy, const int32_t* su, const int32_t* sv,
    const int32_t* by, const int32_t* bu, const int32_t* bv,
    const int32_t* qp, const uint8_t* al, const uint8_t* at,
    const uint8_t* atr, const uint8_t* atl, const uint8_t* mask,
    const int32_t* tab, const float* lam, int32_t* ry, int32_t* ru,
    int32_t* rv, int32_t* use16, int32_t* i16m, int32_t* i4m, int32_t* cm,
    int32_t* ldc, int32_t* lac, int32_t* cdc, int32_t* cac, int* prog,
    int gw, int gh, int chroma_qp_off, int threads) {
  Args a{sy, su, sv, by, bu, bv, qp, al, at, atr, atl, mask, tab, lam,
         ry, ru, rv, use16, i16m, i4m, cm, ldc, lac, cdc, cac, prog, gw,
         gh, chroma_qp_off};
  return emu_launch_cooperative(k_intra_encode, a, gh, threads,
                                SMEM_WORDS) ? 0 : 1;
}
"""


@pytest.fixture(scope="module")
def emulated():
    """The kernel's code built with g++ under the emulation header, in
    ``build/emulated/`` of the checkout."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the emulated kernel")
    text = SOURCE.read_text()
    for line in ("#include <cuda_runtime.h>\n",
                 '#include "device_prims.cuh"\n'):
        text = text.replace(line, "")
    body = text[:text.index("// Plain C entry point")]
    out = REPO / "build" / "emulated" / str(os.getpid())
    out.mkdir(parents=True, exist_ok=True)
    (out / "intra_encode_body.inc").write_text(body)
    (out / "harness.cpp").write_text(HARNESS)
    lib = out / "libemu_intra.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-w",
                    "-shared", "-fPIC", "-pthread", f"-I{TESTS}",
                    f"-I{out}", "-o", str(lib), str(out / "harness.cpp")],
                   check=True, capture_output=True, timeout=300)
    dll = ctypes.CDLL(str(lib))
    dll.emu_intra_encode_frame.restype = ctypes.c_int
    dll.emu_intra_encode_frame.argtypes = [ctypes.c_void_p] * 26 + \
        [ctypes.c_int] * 4
    yield dll
    shutil.rmtree(out, ignore_errors=True)


def _run(dll, args, kw, gw, gh):
    """The emulated kernel on numpy inputs; returns the twin's result
    layout (recY, recU, recV, arrays) as tensors."""
    from hartallo_tpu_torch.encode import intra_encode_fast as F
    from hartallo_tpu_torch.encode.e_device import INTRA_FIELDS
    sy, su, sv, qp, cqo, al, at, lam, atr, atl = args

    def c(a, dtype):
        return None if a is None else np.ascontiguousarray(a, dtype)
    keep = [c(p, np.int32) for p in (sy, su, sv)]
    keep += [c(p, np.int32) for p in kw.get("base_planes", (None,) * 3)]
    keep += [c(qp, np.int32)]
    keep += [c(m, np.uint8) for m in (al, at, atr, atl, kw.get("mb_mask"))]
    keep += [F._tables("cpu").numpy().copy(), np.array([lam], np.float32)]
    rec = [np.zeros(p.shape, np.int32) for p in (sy, su, sv)]
    arrays = {n: np.full((gh, gw, *s), -1, np.int32)
              for n, s in INTRA_FIELDS}
    prog = np.zeros(gh, np.int32)
    stalled = dll.emu_intra_encode_frame(
        *(None if a is None else a.ctypes.data
          for a in (*keep, *rec, *arrays.values(), prog)), gw, gh, cqo,
        F.THREADS)
    assert not stalled, "a row waited for a neighbour that never came"
    np.testing.assert_array_equal(prog, gw)
    return (*map(torch.tensor, rec),
            {n: torch.tensor(v) for n, v in arrays.items()})


CASES = [
    ("4x3, slices of two rows", 4, 3, {}),
    ("2x5 masked", 2, 5, {"masked": True}),
    ("single MB column", 1, 5, {"rows": 5}),
    ("flat source", 4, 3, {"flat": True}),
    ("qp 0..51, offset +5, lambda of qp 45, None tr/tl", 5, 4,
     {"qp": tuple(range(52)), "cqo": 5, "lam_qp": 45, "none_trtl": True}),
    ("6x4 masked, qp 0..12, lambda of qp 12", 6, 4,
     {"masked": True, "qp": tuple(range(13)), "lam_qp": 12}),
    ("6x12, taller than wide", 6, 12, {"rows": 12}),
    ("8x5 diagonal texture", 8, 5, {"rows": 5, "diagonal": True}),
]


@pytest.mark.parametrize("label,gw,gh,opts", CASES,
                         ids=[c[0] for c in CASES])
def test_emulated_kernel_equals_plain_twin(emulated, label, gw, gh, opts):
    from hartallo_tpu_torch.encode.intra_encode import intra_encode_frame
    args, kw = intra_case(gw, gh, 90 + gw * gh, **opts)
    got = _run(emulated, args, kw, gw, gh)

    def t(a):
        if isinstance(a, tuple):
            return tuple(map(t, a))
        return torch.tensor(a) if isinstance(a, np.ndarray) else a
    want = intra_encode_frame(*t(args), **{k: t(v) for k, v in kw.items()},
                              gw=gw, gh=gh)
    for name in want[3]:
        np.testing.assert_array_equal(got[3][name].numpy(),
                                      want[3][name].numpy(), err_msg=name)
    for g, w, name in zip(got[:3], want[:3], "YUV"):
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)
