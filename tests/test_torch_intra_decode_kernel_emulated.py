"""The intra decode CUDA kernel's own code, run on the CPU under an
emulation of the CUDA features it uses, against its plain twin.

``csrc/intra_decode.cu`` up to its C entry point is compiled with g++
after ``tests/cuda_emulation.h`` and launched as the wrapper launches it:
one block of ``intra_recon_fast.THREADS`` per MB row, every row's block
at once (one ``std::thread`` per CUDA thread, barriers for
``__syncthreads``, ``__syncwarp`` and the named barriers that hand the
edge warp's slots to the compute warps, the rows' progress counters and
the warps' done counters on ``std::atomic_ref`` with acquire loads and
release stores, sleeping spin loops).  The rows run as freely as on the
card, so a row that reads its neighbours before they are published reads
stale values; with ``lower_rows_first`` each row starts well before the
row above it, so such a read is stale every time.  This holds the
kernel's indexing, lane mapping, the Intra4x4 taps and chain's steps, the
left columns passed from slot to slot, the neighbour rules at the
picture's and slices' edges and the rows' waits against
``decode/intra_recon.intra_reconstruct`` on every run where there is no
card; nvcc's build and the card stay the authority (the ``cuda`` tests of
``tests/test_torch_intra_decode.py`` and ``chip_smoke.py``).  Inputs:
``chip_smoke.intra_dec_inputs``: I4x4-only, I16-only and mixed pictures,
inter MBs between intra ones, constrained intra prediction over row
slices, the above-right flags false on a row, one MB, 1xN and Nx1
pictures, a picture taller than wide, a texture along the anti-diagonals,
modes past their range (the twin clamps them), a sparse picture (one
intra MB in eight), intra MBs under intra MBs above-right with inter MBs
between them (also with lower rows first), intra MBs whose left MB is
inter, and an all-inter picture (every plane unchanged, every counter at
gw).  ``test_emulated_mutants_fail`` builds three broken copies of the
source (block 5 predicting from the above-right MB where ``avail_tr`` is
false; an MB of kind 2 overwritten by a prediction; a row that does not
wait for the intra MB above-right, run with lower rows first) and shows
that each disagrees with the twin.  Tolerance: exact equality of every
plane.
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
SOURCE = REPO / "hartallo_tpu_torch" / "csrc" / "intra_decode.cu"
HARNESS = r"""
#include "cuda_emulation.h"
#include "intra_decode_body.inc"

extern "C" int emu_intra_decode(
    const int32_t* iy, const int32_t* iu, const int32_t* iv, int32_t* oy,
    int32_t* ou, int32_t* ov, const int32_t* res_y, const int32_t* res_c,
    const int32_t* kind, const int32_t* i16m, const int32_t* i4m,
    const int32_t* cm, const uint8_t* al, const uint8_t* at,
    const uint8_t* atr, const int32_t* tab, int* prog, int gw, int gh,
    int threads, int start_gap_us) {
  Args a{iy, iu, iv, oy, ou, ov, res_y, res_c, kind, i16m, i4m, cm,
         al, at, atr, tab, prog, gw, gh};
  return emu_launch_cooperative(k_intra_decode, a, gh, threads,
                                smem_bytes(gw) / 4, start_gap_us) ? 0 : 1;
}
"""


def _build(text: str, tag: str):
    """The kernel's code in ``text`` built with g++ under the emulation
    header into ``build/emulated/`` of the checkout; returns (the loaded
    library, its directory)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the emulated kernel")
    for line in ("#include <cuda_runtime.h>\n",
                 '#include "device_prims.cuh"\n'):
        text = text.replace(line, "")
    body = text[:text.index("// Plain C entry point")]
    out = REPO / "build" / "emulated" / f"id_{tag}_{os.getpid()}"
    out.mkdir(parents=True, exist_ok=True)
    (out / "intra_decode_body.inc").write_text(body)
    (out / "harness.cpp").write_text(HARNESS)
    lib = out / "libemu_intra_decode.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-w", "-shared", "-fPIC",
                    "-pthread", f"-I{TESTS}", f"-I{out}",
                    f"-I{SOURCE.parent}", "-o", str(lib),
                    str(out / "harness.cpp")],
                   check=True, capture_output=True, timeout=300)
    dll = ctypes.CDLL(str(lib))
    dll.emu_intra_decode.restype = ctypes.c_int
    dll.emu_intra_decode.argtypes = [ctypes.c_void_p] * 17 + \
        [ctypes.c_int] * 4
    return dll, out


@pytest.fixture(scope="module")
def emulated():
    dll, out = _build(SOURCE.read_text(), "main")
    yield dll
    shutil.rmtree(out, ignore_errors=True)


# with lower_rows_first, each row's block starts this long after the
# block of the row below it
START_GAP_US = 200_000


def run(dll, case, gw, gh, lower_rows_first=False):
    """The emulated kernel on the numpy inputs ``case``; returns its three
    planes as tensors."""
    from hartallo_tpu_torch.decode import intra_recon_fast as F
    *planes, res_y, res_c, kind, i16m, i4m, cm, al, at, atr = case

    def c(a, dtype):
        return None if a is None else np.ascontiguousarray(a, dtype)
    keep = [c(p, np.int32) for p in planes]
    out = [p.copy() for p in keep]
    keep += [c(a, np.int32) for a in (res_y, res_c, kind, i16m, i4m, cm)]
    keep += [c(m, np.uint8) for m in (al, at, atr)]
    keep += [F._tables("cpu").numpy().copy()]
    prog = np.zeros(gh, np.int32)
    args = [*keep[:3], *out, *keep[3:], prog]
    stalled = dll.emu_intra_decode(
        *(None if a is None else a.ctypes.data for a in args), gw, gh,
        F.THREADS, START_GAP_US if lower_rows_first else 0)
    assert not stalled, "a row waited for a neighbour that never came"
    np.testing.assert_array_equal(prog, gw)
    return tuple(map(torch.tensor, out))


def twin(case, gw, gh):
    from hartallo_tpu_torch.decode.intra_recon import intra_reconstruct
    t = [None if a is None else torch.tensor(a) for a in case]
    return intra_reconstruct(tuple(t[:3]), *t[3:], gw=gw, gh=gh)


CASES = [
    ("I4x4 only", 5, 4, {"kinds": (0,)}),
    ("I16 only", 5, 4, {"kinds": (1,)}),
    ("mixed", 6, 5, {}),
    ("inter MBs between intra ones", 6, 4, {"kinds": (0, 1, 3, 4, 5)}),
    ("PCM and I_BL kinds left alone", 4, 3, {"kinds": (0, 1, 2, 8)}),
    ("constrained intra, slices of 2 rows", 6, 5,
     {"kinds": (0, 1, 3), "rows": 2, "constrained": True}),
    ("avail_tr false on row 2", 9, 4, {"kinds": (0,), "tr_false_row": 2}),
    ("avail_tr None", 4, 3, {"none_tr": True}),
    ("one MB", 1, 1, {}),
    ("1x5, one MB column", 1, 5, {}),
    ("7x1, one MB row", 7, 1, {}),
    ("3x9, taller than wide", 3, 9, {"rows": 4}),
    ("8x5 diagonal texture", 8, 5, {"diagonal": True}),
    ("modes past their range", 4, 3, {"modes": (12, 6, 6)}),
    ("sparse, one intra MB in eight", 16, 5, {"kinds": (0, 1) + (3,) * 14}),
    ("intra under intra above-right, inter between", 9, 5,
     {"kinds": (0,), "layout": "staircase"}),
    ("intra MBs with an inter left MB", 8, 4,
     {"kinds": (0, 1), "layout": "columns"}),
    ("all inter", 6, 4, {"kinds": (3, 4, 5)}),
]


@pytest.mark.parametrize("label,gw,gh,opts", CASES,
                         ids=[c[0] for c in CASES])
def test_emulated_kernel_equals_plain_twin(emulated, label, gw, gh, opts):
    case = CS.intra_dec_inputs(gw, gh, 300 + 7 * gw + gh, **opts)
    got = run(emulated, case, gw, gh)
    want = twin(case, gw, gh)
    for g, w, name in zip(got, want, "YUV"):
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)
    if opts.get("kinds") == (3, 4, 5):
        for g, p in zip(got, case[:3]):
            np.testing.assert_array_equal(g.numpy(), p)


# (label, gw, gh, intra_dec_inputs options): run with lower rows first
ORDERED = [
    ("intra under intra above-right, lower rows first", 6, 4,
     {"kinds": (0,), "layout": "staircase"}),
    ("mixed, lower rows first", 5, 4, {}),
]


@pytest.mark.parametrize("label,gw,gh,opts", ORDERED,
                         ids=[c[0] for c in ORDERED])
def test_emulated_kernel_lower_rows_first(emulated, label, gw, gh, opts):
    case = CS.intra_dec_inputs(gw, gh, 300 + 7 * gw + gh, **opts)
    got = run(emulated, case, gw, gh, lower_rows_first=True)
    for g, w, name in zip(got, twin(case, gw, gh), "YUV"):
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)


# (label, text replaced, its replacement, the case that shows it, whether
# lower rows start first)
MUTANTS = [
    ("block 5 takes the above-right MB without avail_tr",
     "(at_edge | (atr == 0))", "at_edge",
     (9, 4, {"kinds": (0,), "tr_false_row": 2}), False),
    ("an MB of kind 2 overwritten by a prediction",
     "kind == 0 || kind == 1", "kind == 0 || kind == 1 || kind == 2",
     (4, 3, {"kinds": (0, 1, 2, 8)}), False),
    ("the wait leaves out the intra MB above-right",
     "intra_at(1, n + 1) ? n + 2", "false ? n + 2",
     (6, 4, {"kinds": (0,), "layout": "staircase"}), True),
]


@pytest.mark.parametrize("label,old,new,case,lower_rows_first", MUTANTS,
                         ids=[m[0] for m in MUTANTS])
def test_emulated_mutants_fail(label, old, new, case, lower_rows_first):
    text = SOURCE.read_text()
    assert text.count(old) == 1, old
    dll, out = _build(text.replace(old, new),
                      f"m{[m[0] for m in MUTANTS].index(label)}")
    try:
        gw, gh, opts = case
        inputs = CS.intra_dec_inputs(gw, gh, 300 + 7 * gw + gh, **opts)
        got = run(dll, inputs, gw, gh, lower_rows_first)
        want = twin(inputs, gw, gh)
        assert not all(torch.equal(g, w) for g, w in zip(got, want)), \
            f"the mutant '{label}' went unnoticed"
    finally:
        shutil.rmtree(out, ignore_errors=True)
