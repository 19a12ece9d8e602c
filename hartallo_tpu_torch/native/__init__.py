"""ctypes bindings for the native host codec (slicec.c).

Auto-builds the shared library with the system compiler on first import
(cached in ``build/native/`` of the checkout).  Falls back silently —
callers check ``available()`` and use the pure-Python path otherwise.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess

import numpy as np

_DIR = pathlib.Path(__file__).resolve().parent
_SRC = _DIR / "slicec.c"
_SO = _DIR.parent.parent / "build" / "native" / "slicec.so"
_lib = None


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


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(str(_SO))
    except OSError:
        return None
    i8 = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i16 = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.hl_parse_slice_data.restype = ctypes.c_int64
    lib.hl_parse_slice_data.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i8, i8, i8, i8, i8, u8, u8,
        i32, i32, i32, i32, i16, i16, u8, u8, i32, i32, i8, i8,
        i8, i8, i8,
        ctypes.POINTER(ctypes.c_int64)]
    lib.hl_derive_mvs.restype = ctypes.c_int64
    lib.hl_derive_mvs.argtypes = [
        ctypes.c_int32, ctypes.c_int32, i8, i32, i8, i8, i32, i32]
    lib.hl_compute_mvds_and_skip.restype = ctypes.c_int64
    lib.hl_compute_mvds_and_skip.argtypes = [
        ctypes.c_int32, ctypes.c_int32, i8, i32, i8, i8, u8, i32, i32, u8]
    lib.hl_pack_slice_data.restype = ctypes.c_int64
    lib.hl_pack_slice_data.argtypes = [
        u8, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32, i32, i32, i32, i32, i32, i32, i32,
        i8, i8, i32, i32, i8, u8,
        i16, i16, i32]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def parse_slice_data(rbsp: bytes, bitpos: int, sd, *, first_mb: int,
                     slice_qp: int, is_p: bool, num_ref: int, sid: int,
                     deblock_idc: int, alpha_off: int, beta_off: int):
    """Native slice_data parse into the SliceData SoA.  Returns the number
    of MBs parsed (negative = error)."""
    lib = _load()
    out_pos = ctypes.c_int64(0)
    n = lib.hl_parse_slice_data(
        rbsp, len(rbsp), bitpos,
        sd.gw, sd.gh, first_mb, slice_qp, int(is_p), num_ref, sid,
        deblock_idc, alpha_off, beta_off,
        sd.mb_kind, sd.qp, sd.i16_mode, sd.i4_modes.reshape(-1),
        sd.chroma_mode, sd.cbp_luma, sd.cbp_chroma,
        sd.luma_ac.reshape(-1), sd.luma_dc.reshape(-1),
        sd.chroma_dc.reshape(-1), sd.chroma_ac.reshape(-1),
        sd.nnz_luma.reshape(-1), sd.nnz_chroma.reshape(-1),
        sd.pcm_luma.reshape(-1), sd.pcm_chroma.reshape(-1),
        sd.slice_id.reshape(-1), sd.mvd.reshape(-1),
        sd.ref_idx.reshape(-1), sd.sub_types.reshape(-1),
        sd.deblock_idc.reshape(-1), sd.alpha_off.reshape(-1),
        sd.beta_off.reshape(-1),
        ctypes.byref(out_pos))
    return n, out_pos.value


def pack_slice_data(header_bytes: bytes, header_bits: int, gw: int, gh: int,
                    slice_qp: int, is_p: bool, num_ref: int, sid: int,
                    arrays: dict, qp: np.ndarray, mb_kind: np.ndarray,
                    mvd=None, skip_ok=None, first_mb: int = 0,
                    mb_count: int = -1) -> bytes:
    """Native slice_data pack of a contiguous MB range; returns the complete
    RBSP (header + data + trailing bits), before emulation prevention."""
    lib = _load()
    if mb_count < 0:
        mb_count = gw * gh - first_mb
    cap = mb_count * 1024 + len(header_bytes) + 1024
    buf = np.zeros(cap, np.uint8)
    buf[:len(header_bytes)] = np.frombuffer(header_bytes, np.uint8)
    z32 = np.zeros((gh, gw), np.int32)

    def arr32(name, shape_elems):
        a = arrays.get(name)
        if a is None:
            return np.zeros(gw * gh * shape_elems, np.int32)
        return np.ascontiguousarray(a.reshape(-1).astype(np.int32))

    mvd32 = np.ascontiguousarray(
        (mvd if mvd is not None else
         np.zeros((gh, gw, 4, 4, 2), np.int32)).reshape(-1)
        .astype(np.int32))
    skip8 = np.ascontiguousarray(
        (skip_ok if skip_ok is not None else
         np.zeros((gh, gw), bool)).reshape(-1).astype(np.uint8))
    ref8 = np.ascontiguousarray(
        arrays.get("ref_idx", np.zeros((gh, gw, 4), np.int8))
        .reshape(-1).astype(np.int8))
    sub8 = np.ascontiguousarray(
        arrays.get("sub_types", np.zeros((gh, gw, 4), np.int8))
        .reshape(-1).astype(np.int8))
    nnz_l = np.zeros(16 * gw * gh, np.int16)
    nnz_c = np.zeros(8 * gw * gh, np.int16)
    som = np.full(gw * gh, -1, np.int32)

    end = lib.hl_pack_slice_data(
        buf, cap, header_bits, gw, gh, first_mb, mb_count,
        slice_qp, int(is_p), num_ref, sid,
        arr32("use_i16", 1), arr32("i16_mode", 1), arr32("i4_modes", 16),
        arr32("chroma_mode", 1), arr32("luma_dc", 16),
        arr32("luma_ac", 256), arr32("chroma_dc", 8),
        arr32("chroma_ac", 128),
        ref8, sub8, mvd32,
        np.ascontiguousarray(qp.reshape(-1).astype(np.int32)),
        np.ascontiguousarray(mb_kind.reshape(-1).astype(np.int8)),
        skip8, nnz_l, nnz_c, som)
    if end < 0:
        raise RuntimeError("native pack failed")
    return bytes(buf[:end // 8].tobytes())


def derive_mvs(gw: int, gh: int, mb_kind, mvd, ref_idx, sub_types,
               slice_id) -> np.ndarray:
    """Native 8.4.1 MV derivation (decoder direction).  Returns mv
    (gh,gw,4,4,2) int32."""
    lib = _load()
    mv_out = np.zeros((gh, gw, 4, 4, 2), np.int32)
    lib.hl_derive_mvs(
        gw, gh,
        np.ascontiguousarray(mb_kind.reshape(-1).astype(np.int8)),
        np.ascontiguousarray(mvd.reshape(-1).astype(np.int32)),
        np.ascontiguousarray(ref_idx.reshape(-1).astype(np.int8)),
        np.ascontiguousarray(sub_types.reshape(-1).astype(np.int8)),
        np.ascontiguousarray(slice_id.reshape(-1).astype(np.int32)),
        mv_out.reshape(-1))
    return mv_out


def compute_mvds_and_skip(gw: int, gh: int, mb_kind, mv, ref_idx,
                          sub_types, coded, slice_id):
    """Native 8.4.1 inverse pass (encoder direction).  Returns
    (mvd (gh,gw,4,4,2) int32, skip_ok (gh,gw) bool)."""
    lib = _load()
    mvd_out = np.zeros((gh, gw, 4, 4, 2), np.int32)
    skip_out = np.zeros(gh * gw, np.uint8)
    lib.hl_compute_mvds_and_skip(
        gw, gh,
        np.ascontiguousarray(mb_kind.reshape(-1).astype(np.int8)),
        np.ascontiguousarray(mv.reshape(-1).astype(np.int32)),
        np.ascontiguousarray(ref_idx.reshape(-1).astype(np.int8)),
        np.ascontiguousarray(sub_types.reshape(-1).astype(np.int8)),
        np.ascontiguousarray(coded.reshape(-1).astype(np.uint8)),
        np.ascontiguousarray(slice_id.reshape(-1).astype(np.int32)),
        mvd_out.reshape(-1), skip_out)
    return mvd_out, skip_out.reshape(gh, gw).astype(bool)
