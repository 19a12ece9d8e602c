"""ctypes binding of the native GOP-kernel payload pass (``packc.c``).

``d_pool.pack_fast`` calls ``pack_frame`` when ``available()``; its numpy
body, ``d_pool.pack_fast_py``, is the oracle the native pass matches
byte for byte.  The library builds with the system compiler on first use
into ``build/native/`` of the checkout, atomically, and rebuilds when the
source is newer.  At load the tables and constants it reads are handed
over from ``core/tables.py`` and ``decode/d_pool.py``, so nothing of them
is typed twice.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess

import numpy as np

_DIR = pathlib.Path(__file__).resolve().parent
_SRC = _DIR / "packc.c"
_SO = _DIR.parent.parent / "build" / "native" / "packc.so"
_lib = None
_failed = False
_tables = None   # the tables handed to the library, kept alive


def _build() -> bool:
    try:
        _SO.parent.mkdir(parents=True, exist_ok=True)
        tmp = _SO.with_name(f"{_SO.name}.{os.getpid()}.tmp")
        subprocess.run(["gcc", "-O3", "-shared", "-fPIC", "-o",
                        str(tmp), str(_SRC)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, _SO)
        return True
    except Exception:
        return False


def _i32(a):
    return np.ascontiguousarray(a, np.int32)


def _load():
    global _lib, _failed, _tables
    if _lib is not None or _failed:
        return _lib
    if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
        if not _build():
            _failed = True
            return None
    try:
        lib = ctypes.CDLL(str(_SO))
    except OSError:
        _failed = True
        return None
    from hartallo_tpu_torch.core import tables as T
    from hartallo_tpu_torch.decode import d_pool

    i8 = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i16 = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    c32 = ctypes.c_int32
    lib.hl_pack_tables.restype = None
    lib.hl_pack_tables.argtypes = [i32] * 8 + [c32, c32]
    lib.hl_pack_count.restype = None
    lib.hl_pack_count.argtypes = [c32, c32, c32, i8, i8, i32, i16, i16, i64]
    lib.hl_pack_fast.restype = ctypes.c_int64
    lib.hl_pack_fast.argtypes = [
        c32, c32, c32,
        i8, i8, i8, i8, i8,                  # kind, qp, modes
        i32, i32, i32, i32,                  # levels
        i16, i16, i32, i8, i8,               # nnz, mv, deblock offsets
        u8, u8, u8, u8, u8, u8,              # filter flags, availability
        i64,                                 # hl_pack_count's output
        i32, i16, i32, i16, i32, i16]        # smb, aux, tags, vals, ilist
    _tables = [_i32(T.QUANT_V), _i32(T.DEBLOCK_ALPHA), _i32(T.DEBLOCK_BETA),
               _i32(d_pool._TC0X[:, 1:4]), _i32(T.QP_SCALE_CHROMA),
               _i32(d_pool._QPT_NP), _i32(T.LUMA_4x4_BLK_XY),
               _i32(d_pool._BLK_RASTER_OF)]
    lib.hl_pack_tables(*_tables, d_pool.PAD, d_pool.MAX_RES)
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _flat(a, dtype, size: int):
    """``a`` as a flat C-contiguous array of ``dtype`` (no copy where it
    is one already), checked to hold ``size`` elements, since the library
    reads each array by the picture's MB count."""
    a = np.ascontiguousarray(a, dtype).reshape(-1)
    if a.size != size:
        raise ValueError(f"pack_frame: {a.size} elements where the picture "
                         f"has {size}")
    return a


def pack_frame(sd, fmb_v, fmb_h, fint, chroma_qp_off: int, al, at, atr):
    """The payload arrays of ``d_pool.FastFrame`` for one picture:
    (smb, aux, tags, vals, counts, ilist, ivals).  Raises OverflowError
    where a residual exceeds ``d_pool.MAX_RES``."""
    lib = _load()
    gh, gw = sd.gh, sd.gw
    n = gh * gw
    kind = _flat(sd.mb_kind, np.int8, n)
    qp = _flat(sd.qp, np.int8, n)
    cdc = _flat(sd.chroma_dc, np.int32, 8 * n)
    nnz_l = _flat(sd.nnz_luma, np.int16, 16 * n)
    nnz_c = _flat(sd.nnz_chroma, np.int16, 8 * n)
    cnt = np.zeros(4, np.int64)
    lib.hl_pack_count(gw, gh, chroma_qp_off, kind, qp, cdc, nnz_l, nnz_c,
                      cnt)
    nl, nu, nv, ni = (int(c) for c in cnt)
    nr = nl + nu + nv
    smb = np.empty((n, 8), np.int32)
    aux = np.empty((gh, gw, 62), np.int16)
    tags = np.empty((nr,), np.int32)
    vals = np.empty((nr, 16), np.int16)
    ilist = np.empty((ni, 4), np.int32)
    ivals = np.empty((ni, 24, 16), np.int16)
    none = np.zeros(n, np.uint8)
    avail = [none if x is None else _flat(x, np.uint8, n)
             for x in (al, at, atr)]
    over = lib.hl_pack_fast(
        gw, gh, chroma_qp_off, kind, qp,
        _flat(sd.i16_mode, np.int8, n), _flat(sd.i4_modes, np.int8, 16 * n),
        _flat(sd.chroma_mode, np.int8, n),
        _flat(sd.luma_ac, np.int32, 256 * n),
        _flat(sd.luma_dc, np.int32, 16 * n), cdc,
        _flat(sd.chroma_ac, np.int32, 128 * n), nnz_l, nnz_c,
        _flat(sd.mv, np.int32, 32 * n), _flat(sd.alpha_off, np.int8, n),
        _flat(sd.beta_off, np.int8, n), _flat(fmb_v, np.uint8, n),
        _flat(fmb_h, np.uint8, n), _flat(fint, np.uint8, n), *avail, cnt,
        smb.reshape(-1), aux.reshape(-1), tags, vals.reshape(-1),
        ilist.reshape(-1), ivals.reshape(-1))
    if over:
        raise OverflowError("residual exceeds fast-path int16 budget")
    counts = np.array([nl, nl + nu, nr], np.int32)
    return smb, aux, tags, vals, counts, ilist, ivals
