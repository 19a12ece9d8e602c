"""The P-picture body's CUDA kernels' own code, run on the CPU under an
emulation of the CUDA features they use, against their plain twins.

``csrc/p_encode.cu`` up to its C entry points is compiled with g++ after
``tests/cuda_emulation.h`` (one ``std::thread`` per CUDA thread, barriers
for ``__syncthreads``, the blocks of a grid one after another), with the
headers it shares with ``intra_encode.cu`` and ``d_gop.cu``.  This holds
the four kernels' indexing, clamps, lane mapping, reductions, rounding and
tie-breaks against ``p_device.partition_decide``,
``ops/wide.halfpel_planes``, ``p_device.p_residual`` and
``e_device.deblock_params`` on every run where there is no card; nvcc's
build and the card stay the authority (the ``cuda`` tests of
``tests/test_torch_p_body_fast.py`` and ``chip_smoke.py``).  Inputs:
``chip_smoke.p_inputs`` at 1x1 to 5x4 MBs (the ``bench.make_clip``
frame pair, a halo-padded band reference, a flat and an intra-heavy
source, qp 0, 51 and 0..51 with chroma offsets, seeded MVs far into the
pad at every edge, seeded MB edge flags), and seeded full-search outputs
whose partition costs tie.  ``test_emulated_mutants_fail`` builds three
broken copies of the source (a wrong MC clamp, the luma elimination
dropped, a wrong bS rule) and shows that each disagrees with its twin.
Tolerance: exact equality of every output.
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
from _torch_port import fs_case, intra_lambda

TESTS = pathlib.Path(__file__).resolve().parent
REPO = TESTS.parent
SOURCE = REPO / "hartallo_tpu_torch" / "csrc" / "p_encode.cu"

HARNESS = r"""
#include "cuda_emulation.h"
#include "p_encode_body.inc"

extern "C" void emu_part_decide(const float* c16, const int32_t* v16,
                                const float* c168, const int32_t* v168,
                                const float* c816, const int32_t* v816,
                                const float* c88, const int32_t* v88,
                                const float* lam, long long* choice,
                                float* best, int32_t* mv, int32_t* part,
                                int n) {
  const PdArgs a{c16,  c168, c816, c88,    v16,  v168, v816,
                 v88,  lam,  choice, best, mv,   part, n};
  emu_launch_grid(k_part_decide, a, 2, 1, 32);
}

extern "C" void emu_halfpel(const int32_t* plane, int stride, int hp,
                            int wp, int32_t* out) {
  auto k = [=](int) { k_halfpel_enc(plane, stride, hp, wp, out); };
  emu_launch_grid(k, 0, 2, 1, 64);
}

extern "C" void emu_p_residual(
    const int32_t* sy, const int32_t* su, const int32_t* sv,
    const int32_t* ry, const int32_t* ru, const int32_t* rv,
    const int32_t* mv, const int32_t* qp, const float* best,
    const float* lam, const int32_t* tab, int32_t* wq, int32_t* dcq,
    int32_t* acq, int32_t* oy, int32_t* ou, int32_t* ov, uint8_t* mask,
    int sy_st, int su_st, int sv_st, int ry_st, int ru_st, int rv_st,
    int ry_h, int ry_w, int rc_h, int rc_w, int gw, int gh, int cqo) {
  const PrArgs a{sy,    su,    sv,    ry,    ru,    rv,    mv,    qp,
                 best,  lam,   tab,   wq,    dcq,   acq,   oy,    ou,
                 ov,    mask,  sy_st, su_st, sv_st, ry_st, ru_st, rv_st,
                 ry_h,  ry_w,  rc_h,  rc_w,  gw,    gh,    cqo};
  if (PR_SMEM_WORDS > (int)(sizeof(smem) / sizeof(int))) std::abort();
  emu_launch_grid(k_p_residual, a, gw, gh, PR_THREADS);
}

extern "C" void emu_deblock_params(const int32_t* wq, const int32_t* mv,
                                   const int32_t* ref, const uint8_t* intra,
                                   const int32_t* qp, const uint8_t* fv,
                                   const uint8_t* fh, const int32_t* tab,
                                   int16_t* aux, int gw, int gh, int cqo) {
  const DpArgs a{wq, mv, ref, intra, qp, fv, fh, tab, aux, gw, gh, cqo};
  emu_launch_grid(k_deblock_params, a, 2, 1, 32);
}
"""

P = ctypes.c_void_p
I = ctypes.c_int


def _build(text: str, tag: str):
    """The kernels' code in ``text`` built with g++ under the emulation
    header into ``build/emulated/`` of the checkout; returns (the loaded
    library, its directory)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the emulated kernels")
    text = text.replace("#include <cuda_runtime.h>\n", "")
    body = text[:text.index("// Plain C entry points")]
    out = REPO / "build" / "emulated" / f"p_{tag}_{os.getpid()}"
    out.mkdir(parents=True, exist_ok=True)
    (out / "p_encode_body.inc").write_text(body)
    (out / "harness.cpp").write_text(HARNESS)
    lib = out / "libemu_p.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-w",
                    "-shared", "-fPIC", "-pthread", f"-I{TESTS}",
                    f"-I{out}", f"-I{SOURCE.parent}", "-o", str(lib),
                    str(out / "harness.cpp")],
                   check=True, capture_output=True, timeout=300)
    dll = ctypes.CDLL(str(lib))
    dll.emu_part_decide.argtypes = [P] * 13 + [I]
    dll.emu_halfpel.argtypes = [P, I, I, I, P]
    dll.emu_p_residual.argtypes = [P] * 18 + [I] * 13
    dll.emu_deblock_params.argtypes = [P] * 9 + [I] * 3
    return dll, out


@pytest.fixture(scope="module")
def emulated():
    dll, out = _build(SOURCE.read_text(), "k")
    yield dll
    shutil.rmtree(out, ignore_errors=True)


def _ptr(a):
    return None if a is None else a.ctypes.data


def _c(a, dtype=None):
    return np.ascontiguousarray(a if dtype is None else np.asarray(a, dtype))


def _tab():
    from hartallo_tpu_torch.encode.p_body_fast import _tables
    return _c(_tables("cpu").numpy())


def _eq(got, want, names):
    for g, w, n in zip(got, want, names):
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, n
        np.testing.assert_array_equal(g, w, err_msg=n)


def run_part_decide(dll, fs, lam, gw, gh):
    fs = [_c(a) for a in fs]
    lam_a = np.array([lam], np.float32)
    out = [np.full((gh, gw), -7, np.int64), np.full((gh, gw), -7, np.float32),
           np.full((gh, gw, 16, 2), -7, np.int32),
           np.full((gh, gw, 16), -7, np.int32)]
    dll.emu_part_decide(*map(_ptr, fs), _ptr(lam_a), *map(_ptr, out),
                        gw * gh)
    return out


def run_halfpel(dll, plane):
    out = np.full((4, *plane.shape), -7, np.int32)
    dll.emu_halfpel(_ptr(plane), plane.strides[0] // 4, *plane.shape,
                    _ptr(out))
    return out


def run_p_residual(dll, c, mv, best, gw, gh, intra_in_p=True):
    planes = [_c(p, np.int32) for p in (*c["src"], *c["ref"])]
    luma = (gh * 16 + 64, gw * 16 + 64)
    chroma = (gh * 8 + 64, gw * 8 + 64)
    out = [np.full((gh, gw, 16, 4, 4), -7, np.int32),
           np.full((gh, gw, 2, 2, 2), -7, np.int32),
           np.full((gh, gw, 2, 4, 4, 4), -7, np.int32),
           np.full(luma, -7, np.int32), np.full(chroma, -7, np.int32),
           np.full(chroma, -7, np.int32)]
    mask = np.full((gh, gw), 7, np.uint8) if intra_in_p else None
    lam_a = np.array([c["lam"]], np.float32)
    dll.emu_p_residual(
        *map(_ptr, planes), _ptr(_c(mv, np.int32)), _ptr(_c(c["qp"])),
        _ptr(_c(best, np.float32)), _ptr(lam_a), _ptr(_tab()),
        *map(_ptr, out), _ptr(mask), *(p.shape[1] for p in planes),
        *planes[3].shape, *planes[4].shape, gw, gh, c["cqo"])
    return out + [None if mask is None else mask.astype(bool)]


def run_deblock_params(dll, wq, mv44, ref44, intra, qp, fv, fh, cqo, gw,
                       gh):
    aux = np.full((gh, gw, 62), -7, np.int16)
    flags = [None if f is None else _c(f, np.uint8) for f in (fv, fh)]
    dll.emu_deblock_params(
        _ptr(_c(wq, np.int32)), _ptr(_c(mv44, np.int32)),
        _ptr(_c(ref44, np.int32)), _ptr(_c(intra, np.uint8)),
        _ptr(_c(qp, np.int32)), *map(_ptr, flags), _ptr(_tab()),
        _ptr(aux), gw, gh, cqo)
    return aux


# (label, gw, gh, seed, lambda qp, largest |MV| in pels, tie)
PD_CASES = [
    ("4x3", 4, 3, 1, 30, 30, False),
    ("2x5, costs that tie", 2, 5, 2, 30, 30, True),
    ("5x4 lambda 0, costs that tie", 5, 4, 3, None, 40, True),
    ("one MB, lambda of qp 45", 1, 1, 4, 45, 24, False),
]


@pytest.mark.parametrize("label,gw,gh,seed,lam_qp,mv_max,tie", PD_CASES,
                         ids=[c[0] for c in PD_CASES])
def test_emulated_part_decide_equals_twin(emulated, label, gw, gh, seed,
                                          lam_qp, mv_max, tie):
    from hartallo_tpu_torch.encode.p_device import partition_decide
    fs = fs_case(gw, gh, seed, mv_max, tie)
    lam = np.float32(0) if lam_qp is None else intra_lambda(lam_qp)
    got = run_part_decide(emulated, fs, lam, gw, gh)
    want = partition_decide([torch.tensor(a) for a in fs],
                            torch.tensor(lam), gw=gw, gh=gh)
    _eq(got, want, ("choice", "best_cost", "mv_blk", "part_of_blk"))


# (label, W, H, options of chip_smoke.p_inputs)
P_CASES = [
    ("4x3", 64, 48, {}),
    ("2x5 qp 0..51, offset -4", 32, 80, {"qp": None, "cqo": -4}),
    ("4x3 qp 0, offset +5", 64, 48, {"qp": 0, "cqo": 5}),
    ("4x3 qp 51, offset -12", 64, 48, {"qp": 51, "cqo": -12}),
    ("4x3 MVs into the pad at every edge", 64, 48, {"mv_max": 400}),
    ("5x4 intra-heavy, flags", 80, 64, {"intra": True, "flags": True}),
    ("4x3 flat", 64, 48, {"flat": True}),
    ("3x2 band of 2 rows, halo reference", 48, 128,
     {"band": True, "mv_max": 200}),
    ("one MB", 16, 16, {"mv_max": 100}),
]


def _path_mvs(c, gw, gh):
    """The residual's MVs: the case's seeded ones, or the full search's
    partition decision (integer MVs, times 4)."""
    from hartallo_tpu_torch.encode.me import full_search_int
    from hartallo_tpu_torch.encode.p_device import partition_decide
    fs = full_search_int(torch.tensor(c["src"][0]), torch.tensor(c["ref"][0]),
                         c["lam"], gw=gw, gh=gh, rng=c["rng"])
    _, best, mv, _ = partition_decide(fs, c["lam"], gw=gw, gh=gh)
    return (mv.numpy() if c["mv"] is None else c["mv"]), best.numpy()


@pytest.mark.parametrize("label,W,H,opts", P_CASES,
                         ids=[c[0] for c in P_CASES])
def test_emulated_halfpel_equals_twin(emulated, label, W, H, opts):
    from hartallo_tpu_torch.ops.wide import halfpel_planes
    _, _, c = CS.p_inputs(W, H, 11, **opts)
    ref = _c(c["ref"][0])
    _eq([run_halfpel(emulated, ref)],
        [halfpel_planes(torch.tensor(ref))], ("stack",))
    # a view with a wider row stride, as a band of a larger plane is
    wide = np.zeros((ref.shape[0], ref.shape[1] + 24), np.int32)
    wide[:, 5:5 + ref.shape[1]] = ref
    _eq([run_halfpel(emulated, wide[:, 5:5 + ref.shape[1]])],
        [halfpel_planes(torch.tensor(ref))], ("stack of a view",))


P_NAMES = ("wq", "dcq", "acq", "recY", "recU", "recV", "mask")


def _twin_residual(c, mv, best, gw, gh, intra_in_p=True):
    from hartallo_tpu_torch.encode.p_device import p_residual
    t = [torch.tensor(p) for p in (*c["src"], *c["ref"])]
    return p_residual(*t, torch.tensor(mv), torch.tensor(c["qp"]),
                      torch.tensor(best), torch.tensor(c["lam"]), gw=gw,
                      gh=gh, chroma_qp_off=c["cqo"], intra_in_p=intra_in_p)


@pytest.mark.parametrize("label,W,H,opts", P_CASES,
                         ids=[c[0] for c in P_CASES])
def test_emulated_p_residual_equals_twin(emulated, label, W, H, opts):
    gw, gh, c = CS.p_inputs(W, H, 12, **opts)
    mv, best = _path_mvs(c, gw, gh)
    got = run_p_residual(emulated, c, mv, best, gw, gh)
    want = _twin_residual(c, mv, best, gw, gh)
    _eq(got, want, P_NAMES)
    if opts.get("intra"):
        assert got[-1].any() and not got[-1].all()


def test_emulated_p_residual_without_mask(emulated):
    gw, gh, c = CS.p_inputs(64, 48, 13, mv_max=60)
    mv, best = _path_mvs(c, gw, gh)
    got = run_p_residual(emulated, c, mv, best, gw, gh, intra_in_p=False)
    want = _twin_residual(c, mv, best, gw, gh, intra_in_p=False)
    assert got[-1] is None and want[-1] is None
    _eq(got[:-1], want[:-1], P_NAMES)


def _twin_params(wq, mv44, ref44, intra, c, gw, gh):
    from hartallo_tpu_torch.encode.e_device import deblock_params
    flags = [None if f is None else torch.tensor(f)
             for f in (c["fmb_v"], c["fmb_h"])]
    return deblock_params(torch.tensor(wq), torch.tensor(mv44),
                          torch.tensor(ref44), torch.tensor(intra),
                          torch.tensor(c["qp"]), c["cqo"], *flags, gw=gw,
                          gh=gh)


def _params_inputs(c, gw, gh, seed):
    """The residual's levels and MVs, seeded references and the case's
    intra map: the deblock parameters' inputs."""
    mv, best = _path_mvs(c, gw, gh)
    wq = _twin_residual(c, mv, best, gw, gh)[0].numpy()
    ref44 = np.random.default_rng(seed).integers(0, 2, (gh, gw, 4, 4)) \
        .astype(np.int32)
    return wq, mv.reshape(gh, gw, 4, 4, 2), ref44, c["intra"]


@pytest.mark.parametrize("label,W,H,opts", P_CASES,
                         ids=[c[0] for c in P_CASES])
def test_emulated_deblock_params_equal_twin(emulated, label, W, H, opts):
    gw, gh, c = CS.p_inputs(W, H, 14, **opts)
    wq, mv44, ref44, intra = _params_inputs(c, gw, gh, 15)
    got = run_deblock_params(emulated, wq, mv44, ref44, intra, c["qp"],
                             c["fmb_v"], c["fmb_h"], c["cqo"], gw, gh)
    _eq([got], [_twin_params(wq, mv44, ref44, intra, c, gw, gh)], ("aux",))


# three broken copies of the source: (label, text replaced, replacement,
# the kernel that must then disagree with its twin, chip_smoke.p_inputs'
# W, H and options).  The clamp shows where the pad is not constant
# along the clamped axis: the rows of a band's halo reference; the
# elimination where an MB's few small levels sum below 6 (qp 0..51).
MUTANTS = [
    ("the luma MC origin clamped one row short",
     "clampi(-(PAD - 2), a.ry_h - PAD - 7,",
     "clampi(-(PAD - 2), a.ry_h - PAD - 8,", "p_residual",
     (48, 128, {"band": True, "mv_max": 400})),
    ("the luma elimination dropped",
     "smem[S_FLAG] = ctr < 6;", "smem[S_FLAG] = 0;", "p_residual",
     (64, 48, {"qp": None})),
    ("an intra edge inside the MB at bS 4",
     "return internal && bs == 4 ? 3 : bs;", "return bs;",
     "deblock_params", (64, 48, {})),
]


@pytest.mark.parametrize("label,old,new,kernel,case", MUTANTS,
                         ids=[m[0] for m in MUTANTS])
def test_emulated_mutants_fail(label, old, new, kernel, case):
    """Each broken copy builds and disagrees with its twin on the inputs
    above: the comparison sees a wrong clamp, a dropped elimination and
    a wrong bS rule."""
    text = SOURCE.read_text()
    assert text.count(old) == 1
    # a path of its own: the loader would hand back a library already
    # loaded from the same path
    tag = f"m{[m[0] for m in MUTANTS].index(label)}"
    dll, out = _build(text.replace(old, new), tag)
    try:
        W, H, opts = case
        gw, gh, c = CS.p_inputs(W, H, 16, **opts)
        mv, best = _path_mvs(c, gw, gh)
        if kernel == "p_residual":
            got = run_p_residual(dll, c, mv, best, gw, gh)
            want = _twin_residual(c, mv, best, gw, gh)
        else:
            wq, mv44, ref44, intra = _params_inputs(c, gw, gh, 17)
            got = [run_deblock_params(dll, wq, mv44, ref44, intra,
                                      c["qp"], None, None, c["cqo"], gw,
                                      gh)]
            want = [_twin_params(wq, mv44, ref44, intra, c, gw, gh)]
        with pytest.raises(AssertionError):
            _eq(got, want, P_NAMES)
    finally:
        shutil.rmtree(out, ignore_errors=True)
