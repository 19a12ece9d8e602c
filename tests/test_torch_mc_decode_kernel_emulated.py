"""The GOP scan's residual, MC and ring write CUDA kernels' own code, run
on the CPU under an emulation of the CUDA features they use, against
their plain twins.

``csrc/mc_decode.cu`` (its source from the kernels' includes up to the
C entry points) is compiled with g++ after ``tests/cuda_emulation.h``
(one ``std::thread`` per CUDA thread, the width-16 and xor shuffles, the
blocks of a launch's grid one after another, the block's dynamic shared
memory) and launched with the C entry points' grids and blocks.  This
holds the kernels' indexing, the residual's DC Hadamards and int32
wrap, the MC's clamps, quarter-pel cases, bilinear taps and weights (on
the scan's uint8 ring and the band's int32 stacks) and the ring write's
clamped half-pel tile, chroma slots, margin and output row against
``decode/mc_decode_fast``'s twins on every run where there is no card;
nvcc's build and the card stay the authority (the ``cuda`` tests of
``tests/test_torch_mc_decode.py`` and ``chip_smoke.py``).  Inputs:
``chip_smoke.residual_rec_inputs``, ``mc_dec_inputs`` and
``ring_write_inputs`` at one MB to 9x1 MBs: for the MC (two warps an
MB, a block per strip of four MBs), strips that do not divide gw, one MB
row and one MB column (the pad blocks' edge rows), and coherent motion
(one MV an MB) on the uint8 ring and the int32 band stacks; for the
ring write's 64 x 32 tiles, a last tile row that ends inside the slot,
a tile row wholly in the margin, and padded pictures that end inside a
tile (the fused output row and the margin's zeros).
``test_emulated_mutants_fail`` builds five broken copies of the source
(the MC's luma clamp's upper bound off by one; its chroma fractions dx
and dy swapped; its byte rows' funnel shift in 4-bit steps instead of
bytes; the ring write's output row taking plane b instead of G; the
residual's luma DC Hadamard's first stage gathering a row's lanes
instead of a column's) and shows that each disagrees with its twin.
Tolerance: exact equality.
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
SOURCE = REPO / "hartallo_tpu_torch" / "csrc" / "mc_decode.cu"
HARNESS = r"""
#include "cuda_emulation.h"
#include "mc_body.inc"

extern "C" void emu_residual_dec(const int32_t* rec, int words,
                                 const int* offs, int32_t* res_y,
                                 int32_t* res_c, int K, int gw, int gh,
                                 int cqo) {
  const RdFields f{offs[0], offs[1], offs[2], offs[3], offs[4], offs[5]};
  const RdArgs a{rec, res_y, res_c, f, words, K * gw * gh, gw, gh, cqo};
  emu_launch_grid(k_residual_dec, a, rd_blocks(a.nmb), 1, RD_THREADS);
}

template <class T>
void emu_mc(const void* ry, const void* ru, const void* rv,
            const int32_t* mv, const int32_t* slot, const int32_t* wp_l,
            const int32_t* wp_c, const int32_t* res_y, const int32_t* res_c,
            const uint8_t* inter, int32_t* oy, int32_t* ou, int32_t* ov,
            int ys_h, int ys_w, int cs_h, int cs_w, int gw, int gh) {
  const McArgs<T> a{(const T*)ry, (const T*)ru, (const T*)rv, mv, slot,
                    wp_l, wp_c, res_y, res_c, inter, oy, ou, ov,
                    ys_h, ys_w, cs_h, cs_w, gw, gh};
  if (MC_SMEM_BYTES > (int)sizeof(smem)) std::abort();
  emu_launch_grid(k_mc_dec<T>, a, mc_strips(gw) + 1, mc_grid_rows(gh),
                  MC_THREADS);
}

extern "C" void emu_mc_dec(const void* ry, const void* ru, const void* rv,
                           int bytes, const int32_t* mv, const int32_t* slot,
                           const int32_t* wp_l, const int32_t* wp_c,
                           const int32_t* res_y, const int32_t* res_c,
                           const uint8_t* inter, int32_t* oy, int32_t* ou,
                           int32_t* ov, int ys_h, int ys_w, int cs_h,
                           int cs_w, int gw, int gh) {
  if (bytes == 1)
    emu_mc<uint8_t>(ry, ru, rv, mv, slot, wp_l, wp_c, res_y, res_c, inter,
                    oy, ou, ov, ys_h, ys_w, cs_h, cs_w, gw, gh);
  else
    emu_mc<int32_t>(ry, ru, rv, mv, slot, wp_l, wp_c, res_y, res_c, inter,
                    oy, ou, ov, ys_h, ys_w, cs_h, cs_w, gw, gh);
}

extern "C" void emu_ring_write_dec(const int32_t* y, const int32_t* u,
                                   const int32_t* v, int ys, int us, int vs,
                                   uint8_t* ring_y, uint8_t* ring_u,
                                   uint8_t* ring_v, uint8_t* out, int hr,
                                   int wr, int hcr, int wcr, int gw, int gh) {
  const RwArgs a{y, u, v, ring_y, ring_u, ring_v, out, ys, us, vs,
                 hr, wr, hcr, wcr, gw, gh};
  if (RW_SMEM_BYTES > (int)sizeof(smem)) std::abort();
  emu_launch_grid(k_ring_write_dec, a, rw_blocks(hr, wr, hcr, wcr), 1,
                  RW_THREADS);
}
"""


def _build(text: str, tag: str):
    """The kernels' code in ``text`` built with g++ under the emulation
    header into ``build/emulated/`` of the checkout; returns (the loaded
    library, its directory)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the emulated kernels")
    start = text.index('#include "halfpel_prims.cuh"\n')
    body = text[start:text.index("// Plain C entry points")]
    out = REPO / "build" / "emulated" / f"mc_{tag}_{os.getpid()}"
    out.mkdir(parents=True, exist_ok=True)
    (out / "mc_body.inc").write_text(body)
    (out / "harness.cpp").write_text(HARNESS)
    lib = out / "libemu_mc_decode.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-w", "-shared", "-fPIC",
                    "-pthread", f"-I{TESTS}", f"-I{out}",
                    f"-I{SOURCE.parent}", "-o", str(lib),
                    str(out / "harness.cpp")],
                   check=True, capture_output=True, timeout=300)
    dll = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    dll.emu_residual_dec.argtypes = [P, I, P, P, P] + [I] * 4
    dll.emu_mc_dec.argtypes = [P] * 3 + [I] + [P] * 10 + [I] * 6
    dll.emu_ring_write_dec.argtypes = [P] * 3 + [I] * 3 + [P] * 4 + [I] * 6
    return dll, out


@pytest.fixture(scope="module")
def emulated():
    dll, out = _build(SOURCE.read_text(), "main")
    yield dll
    shutil.rmtree(out, ignore_errors=True)


def _aligned(a: np.ndarray) -> np.ndarray:
    """A C-contiguous copy of ``a`` whose data starts 64-byte aligned (the
    kernels load and store 16 bytes at a time)."""
    buf = np.empty(a.nbytes + 64, np.uint8)
    off = -buf.ctypes.data % 64
    out = buf[off:off + a.nbytes].view(a.dtype).reshape(a.shape)
    out[...] = a
    return out


def run_residual(dll, rec, offs, cqo, gw, gh):
    rec = _aligned(rec)
    K = rec.shape[0]
    res_y = _aligned(np.full((K, gh * 16, gw * 16), -1, np.int32))
    res_c = _aligned(np.full((K, 2, gh * 8, gw * 8), -1, np.int32))
    dll.emu_residual_dec(rec.ctypes.data, rec.shape[2],
                         (ctypes.c_int * 6)(*offs), res_y.ctypes.data,
                         res_c.ctypes.data, K, gw, gh, cqo)
    return res_y, res_c


def run_mc(dll, case, gw, gh):
    stackY, ringU, ringV, *rest = (_aligned(np.asarray(a)) for a in case)
    H, W = gh * 16, gw * 16
    outs = [_aligned(np.full(s, -1, np.int32)) for s in (
        (H + 64, W + 64), (H // 2 + 64, W // 2 + 64),
        (H // 2 + 64, W // 2 + 64))]
    dll.emu_mc_dec(stackY.ctypes.data, ringU.ctypes.data, ringV.ctypes.data,
                   stackY.itemsize, *(a.ctypes.data for a in rest),
                   *(o.ctypes.data for o in outs), stackY.shape[2],
                   stackY.shape[3], ringU.shape[1], ringU.shape[2], gw, gh)
    return outs


def run_ring_write(dll, planes, rings, ws, out, gw, gh):
    H, W = gh * 16, gw * 16
    planes = [_aligned(p) for p in planes]
    rings = [_aligned(r) for r in rings]
    out = _aligned(out)
    views = [p[32:32 + h, 32:32 + w] for p, (h, w) in
             zip(planes, ((H, W), (H // 2, W // 2), (H // 2, W // 2)))]
    _, _, hr, wr = rings[0].shape
    _, hcr, wcr = rings[1].shape
    dll.emu_ring_write_dec(*(v.ctypes.data for v in views),
                           *(p.shape[1] for p in planes),
                           *(r[ws].ctypes.data for r in rings),
                           out.ctypes.data, hr, wr, hcr, wcr, gw, gh)
    return rings, out


def twin_residual(rec, offs, cqo, gw, gh):
    from hartallo_tpu_torch.decode.mc_decode_fast import residual_planes_plain
    return [t.numpy() for t in residual_planes_plain(
        torch.tensor(rec), offs, cqo, gw=gw, gh=gh)]


def twin_mc(case, gw, gh):
    from hartallo_tpu_torch.decode.mc_decode_fast import mc_recon_plain
    return [t.numpy() for t in mc_recon_plain(
        *(torch.tensor(a) for a in case), gw=gw, gh=gh)]


def twin_ring_write(planes, rings, ws, out, gw, gh):
    from hartallo_tpu_torch.decode.mc_decode_fast import ring_write_plain
    H, W = gh * 16, gw * 16
    t = [torch.tensor(p) for p in planes]
    tr = [torch.tensor(r) for r in rings]
    to = torch.tensor(out)
    ring_write_plain(t[0][32:32 + H, 32:32 + W],
                     t[1][32:32 + H // 2, 32:32 + W // 2],
                     t[2][32:32 + H // 2, 32:32 + W // 2], *tr, ws, to,
                     gw=gw, gh=gh)
    return [r.numpy() for r in tr], to.numpy()


@pytest.mark.parametrize("cqo", [-12, 0, 12])
@pytest.mark.parametrize("gw,gh,K", [(1, 1, 1), (5, 3, 2), (3, 2, 3)])
def test_emulated_residual_equals_twin(emulated, gw, gh, K, cqo):
    rec, offs = CS.residual_rec_inputs(gw, gh, K, 20 + gw * gh + cqo)
    for got, want in zip(run_residual(emulated, rec, offs, cqo, gw, gh),
                         twin_residual(rec, offs, cqo, gw, gh)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("band", [False, True], ids=["uint8 ring",
                                                     "int32 band stacks"])
@pytest.mark.parametrize("gw,gh,S", [(1, 1, 1), (4, 3, 3), (5, 2, 2)])
def test_emulated_mc_equals_twin(emulated, gw, gh, S, band):
    case = CS.mc_dec_inputs(gw, gh, S, 11 + gw * gh + S, band=band)
    for got, want, name in zip(run_mc(emulated, case, gw, gh),
                               twin_mc(case, gw, gh), "YUV"):
        np.testing.assert_array_equal(got, want, err_msg=name)


# the MC's layout: strips of 4 MBs that do not divide gw, one MB row or
# column (both edge rows at once), coherent motion (one MV an MB, so that
# a block's taps fall on every byte alignment of the ring's words), on the
# uint8 ring and the int32 band stacks
MC_LAYOUTS = [("ragged strip 6x4", 6, 4, 3, False, False),
              ("one MB row 9x1", 9, 1, 2, False, False),
              ("one MB column 1x5", 1, 5, 2, False, False),
              ("coherent 7x3", 7, 3, 3, False, True),
              ("band ragged strip 6x2", 6, 2, 2, True, False),
              ("band coherent 5x3", 5, 3, 2, True, True)]


@pytest.mark.parametrize("label,gw,gh,S,band,coherent", MC_LAYOUTS,
                         ids=[c[0] for c in MC_LAYOUTS])
def test_emulated_mc_layout_equals_twin(emulated, label, gw, gh, S, band,
                                        coherent):
    case = CS.mc_dec_inputs(gw, gh, S, 70 + gw * gh, band=band,
                            coherent=coherent)
    for got, want, name in zip(run_mc(emulated, case, gw, gh),
                               twin_mc(case, gw, gh), "YUV"):
        np.testing.assert_array_equal(got, want, err_msg=name)


def check_ring_write(dll, gw, gh, S, seed):
    planes, rings, ws, out = CS.ring_write_inputs(gw, gh, S, seed)
    got = run_ring_write(dll, planes, rings, ws, out, gw, gh)
    want = twin_ring_write(planes, rings, ws, out, gw, gh)
    same = [np.array_equal(g, w) for g, w in zip((*got[0], got[1]),
                                                  (*want[0], want[1]))]
    return dict(zip(("ringY", "ringU", "ringV", "out"), same))


# the ring write's tiles, besides one MB and 3x2 MBs: one MB row (the
# last tile row ends inside the slot, below the padded picture), four (a
# tile row wholly in the margin), a width whose padded picture ends
# inside a tile (the output row's luma and chroma stop there, the
# margin's zeros start)
@pytest.mark.parametrize("gw,gh,S", [(1, 1, 2), (3, 2, 3), (5, 1, 2),
                                     (4, 4, 2), (7, 3, 2)])
def test_emulated_ring_write_equals_twin(emulated, gw, gh, S):
    same = check_ring_write(emulated, gw, gh, S, 5 + gw * gh)
    assert all(same.values()), same


# (label, the text replaced, its replacement, the kernel it breaks)
MUTANTS = [
    ("luma clamp off by one", "W + PAD - 7, px + (mvx >> 2)",
     "W + PAD - 6, px + (mvx >> 2)", "mc"),
    ("chroma dx and dy swapped", "const int dx = mvx & 7, dy = mvy & 7;",
     "const int dx = mvy & 7, dy = mvx & 7;", "mc"),
    ("DC Hadamard on a row's lanes", "dc, (i << 2) | hj, 16)",
     "dc, (hj << 2) | i, 16)", "residual"),
    ("byte row's word shift in 4-bit steps", "(unsigned)(a & 3) << 3",
     "(unsigned)(a & 3) << 2", "mc"),
    ("output row's luma from b", "pack4(q[0][0], q[0][1], q[0][2], q[0][3])",
     "pack4(q[1][0], q[1][1], q[1][2], q[1][3])", "ring_write"),
]


@pytest.mark.parametrize("label,old,new,kernel", MUTANTS,
                         ids=[m[0] for m in MUTANTS])
def test_emulated_mutants_fail(label, old, new, kernel):
    text = SOURCE.read_text()
    assert text.count(old) == 1, old
    dll, out = _build(text.replace(old, new),
                      f"m{[m[0] for m in MUTANTS].index(label)}")
    try:
        gw, gh = 4, 3
        if kernel == "mc":
            case = CS.mc_dec_inputs(gw, gh, 3, 21)
            pairs = zip(run_mc(dll, case, gw, gh), twin_mc(case, gw, gh))
        elif kernel == "ring_write":
            pairs = [(check_ring_write(dll, gw, gh, 2, 21)["out"], True)]
        else:
            rec, offs = CS.residual_rec_inputs(gw, gh, 2, 21)
            pairs = zip(run_residual(dll, rec, offs, 0, gw, gh),
                        twin_residual(rec, offs, 0, gw, gh))
        assert not all(np.array_equal(g, w) for g, w in pairs), \
            f"the mutant '{label}' went unnoticed"
    finally:
        shutil.rmtree(out, ignore_errors=True)
