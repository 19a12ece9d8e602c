"""The motion search CUDA kernels' own code, run on the CPU under an
emulation of the CUDA features they use, against their plain twins.

``csrc/me_search.cu`` up to its C entry points is compiled with g++
after ``tests/cuda_emulation.h``, which runs each block as one
``std::thread`` per CUDA thread (barriers for ``__syncthreads``, a slot
array for the warp shuffles, the byte-SIMD intrinsics as integer code)
and the blocks of a grid one after another.  This holds the kernels'
indexing, byte-shifted window copies, strip masks, clamps, costs,
rounding and tie-breaks against ``encode/me.full_search_int`` and
``refine_subpel`` on every run where there is no card; nvcc's build and
the card stay the authority (the ``cuda`` tests and ``chip_smoke.py``).
The full search runs at strips of 1 to 8 MBs a block, among them strips
that the row's end cuts short, at ranges 0 to 32; the refinement as one
round and as the two-round launch against the twin's chain (half-pel,
then quarter-pel on its MVs).  Inputs: seeded numpy planes (a textured
one, a flat one, a periodic one whose SADs tie), a halo-padded
reference taller than the source, seeded MVs up to 400 quarter-pels
(far outside the picture) and partition maps.  Tolerance: exact
equality of every output.
"""
import ctypes
import os
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from _torch_port import intra_lambda, me_planes, me_refine_maps

TESTS = pathlib.Path(__file__).resolve().parent
REPO = TESTS.parent
SOURCE = REPO / "hartallo_tpu_torch" / "csrc" / "me_search.cu"

HARNESS = r"""
#include "cuda_emulation.h"
#include "me_search_body.inc"

extern "C" void emu_full_search(
    const int32_t* src, const int32_t* ref, const float* lam, float* c16,
    int32_t* v16, float* c168, int32_t* v168, float* c816, int32_t* v816,
    float* c88, int32_t* v88, int src_stride, int ref_stride, int gw,
    int gh, int rng, int strip) {
  if (strip == 0) strip = fs_strip(gw, gh);
  const FsArgs a = fs_args(src, ref, lam, c16, v16, c168, v168, c816, v816,
                           c88, v88, src_stride, ref_stride, gw, gh, rng,
                           strip);
  if (fs_smem_bytes(a) > (int)sizeof(smem)) std::abort();
  emu_launch_grid(k_full_search, a, (gw + strip - 1) / strip, gh,
                  32 * strip);
}

extern "C" void emu_refine(const int32_t* src, const int32_t* hp,
                           const int32_t* mv, const int32_t* part,
                           const float* lam, int32_t* mv_out,
                           float* cost_out, int src_stride, int hp_h,
                           int hp_w, int gw, int gh, int nparts, int nsteps,
                           int step0, int step1, int use_satd) {
  const int rs = rf_side(step0, step1, nsteps);
  if (nsteps < 1 || nsteps > 2 || rs == 0 ||
      rf_smem_bytes(rs) > (int)sizeof(smem))
    std::abort();
  const RfArgs a{src, hp, mv, part, lam, mv_out, cost_out, src_stride,
                 hp_h, hp_w, gw, gh, nparts, nsteps, step0, step1,
                 use_satd};
  const int blocks = (gw * gh + 2 * RF_WARPS - 1) / (2 * RF_WARPS);
  if (rs == 6)
    emu_launch_grid(k_refine<6>, a, blocks, 1, RF_THREADS);
  else
    emu_launch_grid(k_refine<9>, a, blocks, 1, RF_THREADS);
}
"""


@pytest.fixture(scope="module")
def emulated():
    """The kernels' code built with g++ under the emulation header, in
    ``build/emulated/`` of the checkout."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the emulated kernels")
    text = SOURCE.read_text().replace("#include <cuda_runtime.h>\n", "")
    body = text[:text.index("// Plain C entry point")]
    out = REPO / "build" / "emulated" / f"me_{os.getpid()}"
    out.mkdir(parents=True, exist_ok=True)
    (out / "me_search_body.inc").write_text(body)
    (out / "harness.cpp").write_text(HARNESS)
    lib = out / "libemu_me.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-w",
                    "-shared", "-fPIC", "-pthread", f"-I{TESTS}",
                    f"-I{out}", "-o", str(lib), str(out / "harness.cpp")],
                   check=True, capture_output=True, timeout=300)
    dll = ctypes.CDLL(str(lib))
    dll.emu_full_search.argtypes = [ctypes.c_void_p] * 11 + \
        [ctypes.c_int] * 6
    dll.emu_refine.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
    yield dll
    shutil.rmtree(out, ignore_errors=True)


def _full_search(dll, src, ref, lam, gw, gh, rng, strip):
    shapes = ((gh, gw), (gh, gw, 2), (gh, gw, 2), (gh, gw, 2, 2),
              (gh, gw, 2), (gh, gw, 2, 2), (gh, gw, 4), (gh, gw, 4, 2))
    out = [np.full(s, -7, np.int32 if i % 2 else np.float32)
           for i, s in enumerate(shapes)]
    lam_a = np.array([lam], np.float32)
    dll.emu_full_search(src.ctypes.data, ref.ctypes.data, lam_a.ctypes.data,
                        *(o.ctypes.data for o in out), src.shape[1],
                        ref.shape[1], gw, gh, rng, strip)
    return out


def _eq(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = w.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, i
        np.testing.assert_array_equal(g, w, err_msg=f"output {i}")


# (label, gw, gh, rng, plane kind, extra reference rows, lambda qp, MBs a
# block: 0 takes the launch's own choice, fs_strip, which is 1 at these
# sizes; a strip wider than what is left of the row masks the rest)
FS_CASES = [
    ("4x3 range 12", 4, 3, 12, "textured", 0, 30, 8),
    ("2x5 range 5, lambda of qp 45", 2, 5, 5, "textured", 0, 45, 2),
    ("3x2 range 0", 3, 2, 0, "textured", 0, 30, 2),
    ("flat, lambda of qp 12", 3, 2, 12, "flat", 0, 12, 4),
    ("periodic (tied SADs)", 3, 2, 12, "periodic", 0, 30, 3),
    ("periodic, lambda 0 (every tie)", 2, 2, 8, "periodic", 0, None, 0),
    ("halo reference 16 rows taller, range 24", 2, 2, 24, "textured", 16,
     30, 2),
    ("range 32 (the whole pad)", 1, 2, 32, "textured", 0, 30, 8),
    ("7x2, strips of 4 and a ragged 3", 7, 2, 12, "textured", 0, 30, 4),
    ("5x2, strips of 2 and a ragged 1", 5, 2, 12, "textured", 0, 30, 2),
    ("one MB", 1, 1, 12, "textured", 0, 30, 0),
    ("range 24, the encoder's largest", 3, 2, 24, "textured", 0, 30, 8),
    ("range 1", 3, 2, 1, "textured", 0, 45, 8),
]


@pytest.mark.parametrize("label,gw,gh,rng,kind,extra,lam_qp,strip",
                         FS_CASES, ids=[c[0] for c in FS_CASES])
def test_emulated_full_search_equals_plain_twin(emulated, label, gw, gh,
                                                rng, kind, extra, lam_qp,
                                                strip):
    from hartallo_tpu_torch.encode.me import full_search_int
    src, ref = me_planes(gw, gh, 60 + gw * gh, kind, extra)
    lam = np.float32(0) if lam_qp is None else intra_lambda(lam_qp)
    got = _full_search(emulated, src, ref, lam, gw, gh, rng, strip)
    want = full_search_int(torch.tensor(src), torch.tensor(ref), lam, gw=gw,
                           gh=gh, rng=rng)
    _eq(got, want)


RF_CASES = [
    ("half-pel, SATD", 4, 3, 2, 4, True, 60, "textured"),
    ("quarter-pel, SATD", 4, 3, 1, 4, True, 60, "textured"),
    ("half-pel, SAD", 2, 5, 2, 4, False, 60, "textured"),
    ("quarter-pel, 16 partitions", 3, 2, 1, 16, True, 60, "textured"),
    ("one partition, MVs far outside", 3, 2, 2, 1, True, 400, "textured"),
    ("flat, SAD (every tie)", 2, 2, 1, 4, False, 60, "flat"),
    ("periodic, SATD", 2, 3, 2, 4, True, 60, "periodic"),
    ("step -3, SATD", 3, 2, -3, 4, True, 60, "textured"),
    ("step 8, the widest window, SAD", 3, 2, 8, 4, False, 400, "textured"),
]


def _refine(dll, gw, gh, steps, nparts, satd, mv_max, kind, maps=None):
    """The emulated launch of ``steps`` rounds and the twin's chain, on
    seeded MVs of every block (``me_refine_maps``) or on ``maps``."""
    from hartallo_tpu_torch.encode.me import refine_subpel
    from hartallo_tpu_torch.ops.wide import halfpel_planes
    src, ref = me_planes(gw, gh, 80 + gw * gh, kind)
    mv, part = maps or me_refine_maps(gw, gh, 90 + nparts, nparts, mv_max)
    lam = intra_lambda(30)
    hp = np.ascontiguousarray(halfpel_planes(torch.tensor(ref)).numpy())
    mv_out = np.full(mv.shape, -7, np.int32)
    cost = np.full((gh, gw, nparts), -7, np.float32)
    lam_a = np.array([lam], np.float32)
    dll.emu_refine(src.ctypes.data, hp.ctypes.data, mv.ctypes.data,
                   part.ctypes.data, lam_a.ctypes.data, mv_out.ctypes.data,
                   cost.ctypes.data, src.shape[1], hp.shape[1], hp.shape[2],
                   gw, gh, nparts, len(steps), steps[0], steps[-1],
                   int(satd))
    want = (torch.tensor(mv), None)
    for step in steps:
        want = refine_subpel(torch.tensor(src), torch.tensor(ref), want[0],
                             torch.tensor(part), lam, step, gw=gw, gh=gh,
                             nparts=nparts, use_satd=satd,
                             hp=torch.tensor(hp))
    return [mv_out, cost], want


@pytest.mark.parametrize("label,gw,gh,step,nparts,satd,mv_max,kind",
                         RF_CASES, ids=[c[0] for c in RF_CASES])
def test_emulated_refine_equals_plain_twin(emulated, label, gw, gh, step,
                                           nparts, satd, mv_max, kind):
    _eq(*_refine(emulated, gw, gh, (step,), nparts, satd, mv_max, kind))


@pytest.mark.parametrize("label,gw,gh,step,nparts,satd,mv_max,kind",
                         RF_CASES, ids=[c[0] for c in RF_CASES])
def test_emulated_two_rounds_equal_twin_chain(emulated, label, gw, gh, step,
                                              nparts, satd, mv_max, kind):
    """One launch of both rounds (half-pel, then quarter-pel on its MVs)
    against ``refine_subpel(step 2)`` -> ``refine_subpel(step 1)``."""
    _eq(*_refine(emulated, gw, gh, (2, 1), nparts, satd, mv_max, kind))


def _partition_maps(gw, gh, seed, nparts):
    """MVs as the encoder's path gives them: the blocks of a partition
    share its MV, and an MB's partitions lie within 2 pels of its own MV
    (a random one within 15 pels), so that neighbouring blocks' windows
    overlap; MB 0's last partition lies 25 pels away."""
    r = np.random.default_rng(seed)
    part = r.integers(0, nparts, (gh, gw, 16)).astype(np.int32)
    mv_part = r.integers(-60, 61, (gh, gw, 1, 2)) + \
        r.integers(-8, 9, (gh, gw, nparts, 2))
    mv_part[0, 0, nparts - 1] += 100
    part[0, 0, 15] = nparts - 1
    mv = np.take_along_axis(mv_part, part[..., None].astype(np.int64), 2)
    return mv.astype(np.int32), part


# (label, gw, gh, nparts, use_satd, steps)
PATH_CASES = [
    ("4 partitions, SATD, both rounds", 4, 3, 4, True, (2, 1)),
    ("4 partitions, SAD, quarter-pel round", 3, 2, 4, False, (1,)),
    ("1 partition, SATD, both rounds", 3, 3, 1, True, (2, 1)),
    ("16 partitions, SATD, half-pel round", 2, 3, 16, True, (2,)),
]


@pytest.mark.parametrize("label,gw,gh,nparts,satd,steps", PATH_CASES,
                         ids=[c[0] for c in PATH_CASES])
def test_emulated_refine_on_partition_mvs_equals_twin(emulated, label, gw,
                                                      gh, nparts, satd,
                                                      steps):
    """MVs shared by each partition's blocks, as on the encoder's path."""
    maps = _partition_maps(gw, gh, 70 + gw * gh + nparts, nparts)
    _eq(*_refine(emulated, gw, gh, steps, nparts, satd, 0, "textured",
                 maps))
