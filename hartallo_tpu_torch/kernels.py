"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled at first use with ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface,
``build/kernels/libhl_kernels.so`` in the checkout, and loaded with
``ctypes`` (the way ``hartallo_tpu/native`` loads its C parser).  A build
that exists and is newer than every source is reused.  A failed build
raises; there is no fallback.
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
SOURCES = ("d_gop.cu",)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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


def build() -> pathlib.Path:
    """Compile csrc/ into LIB unless an up-to-date build exists."""
    global BUILD_LOG
    inputs = [_CSRC / s for s in SOURCES] + list(_CSRC.glob("*.cuh"))
    if LIB.exists() and all(LIB.stat().st_mtime >= p.stat().st_mtime
                            for p in inputs):
        return LIB
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB.with_name(f"{LIB.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(_CSRC / s) for s in SOURCES]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{BUILD_LOG}")
    os.replace(tmp, LIB)
    return LIB


def load():
    """The loaded kernel library (built on first use), argtypes set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.hl_decode_gop.restype = I
        lib.hl_decode_gop.argtypes = [P] * 15 + [I] * 10 + [P]
        lib.hl_cuda_error_string.restype = ctypes.c_char_p
        lib.hl_cuda_error_string.argtypes = [I]
        _lib = lib
    return _lib


def error_string(code: int) -> str:
    return load().hl_cuda_error_string(code).decode()
