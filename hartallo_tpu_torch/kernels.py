"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled at first use with its own ``nvcc``
for Hopper (``sm_90a``), all of them at once, and the objects are linked
into one shared library with a plain C interface,
``build/kernels/libhl_kernels.so`` in the checkout, loaded with ``ctypes``
(the way ``hartallo_tpu/native`` loads its C parser).  A build that exists
and is newer than every source is reused.  A failed build raises; there
is no fallback.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build" / \
    "kernels"
LIB = BUILD_DIR / "libhl_kernels.so"
SOURCES = ("d_gop.cu", "deblock.cu", "intra_decode.cu", "intra_encode.cu",
           "me_search.cu", "p_encode.cu", "mc_decode.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

BUILD_LOG = ""       # nvcc's output of the last build in this process
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or in /usr/local/cuda/bin)")


def _run(cmds):
    """Run the commands in parallel; returns their (returncode, output)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    return [(p.returncode, out) for p, out in
            ((p, p.communicate()[0]) for p in procs)]


def build() -> pathlib.Path:
    """Compile csrc/ into LIB unless an up-to-date build exists."""
    global BUILD_LOG
    inputs = [_CSRC / s for s in SOURCES] + list(_CSRC.glob("*.cuh"))
    if LIB.exists() and all(LIB.stat().st_mtime >= p.stat().st_mtime
                            for p in inputs):
        return LIB
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    objs = [BUILD_DIR / f"{s}.{tag}.o" for s in SOURCES]
    results = _run([[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                     str(o), str(_CSRC / s)]
                    for s, o in zip(SOURCES, objs)])
    BUILD_LOG = "".join(f"== {s}\n{out}" for s, (_, out) in
                        zip(SOURCES, results))
    tmp = LIB.with_name(f"{LIB.name}.{tag}.tmp")
    try:
        for s, (rc, _) in zip(SOURCES, results):
            if rc != 0:
                raise RuntimeError(f"nvcc failed on {s} ({rc}):\n{BUILD_LOG}")
        [(rc, out)] = _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                             *map(str, objs)]])
        BUILD_LOG += f"== link\n{out}"
        if rc != 0:
            raise RuntimeError(f"nvcc link failed ({rc}):\n{BUILD_LOG}")
        os.replace(tmp, LIB)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    return LIB


def load():
    """The loaded kernel library (built on first use), argtypes set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.hl_decode_gop.restype = I
        lib.hl_decode_gop.argtypes = [P] * 16 + [I] * 10 + [P]
        lib.hl_deblock_frame.restype = I
        lib.hl_deblock_frame.argtypes = [P] * 5 + [I] * 2 + [P]
        lib.hl_deblock_params_dec.restype = I
        lib.hl_deblock_params_dec.argtypes = [P, I, P, P, P] + [I] * 4 + [P]
        lib.hl_intra_decode.restype = I
        lib.hl_intra_decode.argtypes = [P] * 17 + [I] * 3 + [P]
        lib.hl_intra_encode_frame.restype = I
        lib.hl_intra_encode_frame.argtypes = [P] * 26 + [I] * 4 + [P]
        lib.hl_intra_encode_attributes.restype = I
        lib.hl_intra_encode_attributes.argtypes = [P]
        lib.hl_full_search_int.restype = I
        lib.hl_full_search_int.argtypes = [P] * 11 + [I] * 5 + [P]
        lib.hl_refine_subpel.restype = I
        lib.hl_refine_subpel.argtypes = [P] * 7 + [I] * 10 + [P]
        lib.hl_me_attributes.restype = I
        lib.hl_me_attributes.argtypes = [P]
        lib.hl_part_decide.restype = I
        lib.hl_part_decide.argtypes = [P] * 13 + [I, P]
        lib.hl_halfpel_enc.restype = I
        lib.hl_halfpel_enc.argtypes = [P, I, I, I, P, P]
        lib.hl_p_residual.restype = I
        lib.hl_p_residual.argtypes = [P] * 18 + [I] * 13 + [P]
        lib.hl_deblock_params.restype = I
        lib.hl_deblock_params.argtypes = [P] * 9 + [I] * 3 + [P]
        lib.hl_p_encode_attributes.restype = I
        lib.hl_p_encode_attributes.argtypes = [P]
        lib.hl_residual_dec.restype = I
        lib.hl_residual_dec.argtypes = [P, I, P, P, P] + [I] * 4 + [P]
        lib.hl_mc_dec.restype = I
        lib.hl_mc_dec.argtypes = [P] * 3 + [I] + [P] * 10 + [I] * 6 + [P]
        lib.hl_ring_write_dec.restype = I
        lib.hl_ring_write_dec.argtypes = [P] * 3 + [I] * 3 + [P] * 4 + \
            [I] * 6 + [P]
        lib.hl_cuda_error_string.restype = ctypes.c_char_p
        lib.hl_cuda_error_string.argtypes = [I]
        _lib = lib
    return _lib


def error_string(code: int) -> str:
    return load().hl_cuda_error_string(code).decode()
