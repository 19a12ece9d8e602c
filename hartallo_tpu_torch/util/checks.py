"""Verification utilities: plane checksums and quality metrics.

Reference parity: MD5 plane checksums used for decoder verification
(``hl_codec_264.c:322-371``, ``hl_codec_264_mb.c:927-975``) and the PSNR
harness the rebuild adds per SURVEY.md §4.
"""
from __future__ import annotations

import hashlib
import math

import numpy as np


def plane_md5(plane: np.ndarray) -> str:
    """MD5 of a plane's raster bytes (uint8)."""
    return hashlib.md5(np.ascontiguousarray(plane, dtype=np.uint8)
                       .tobytes()).hexdigest()


def frame_md5(frame: np.ndarray, width: int, height: int):
    """Per-plane MD5 of a packed I420 frame: (Y, U, V) hex digests."""
    ysz = width * height
    y = frame[:ysz]
    u = frame[ysz:ysz + ysz // 4]
    v = frame[ysz + ysz // 4:ysz + ysz // 2]
    return plane_md5(y), plane_md5(u), plane_md5(v)


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64))
                  ** 2)
    if mse == 0:
        return float("inf")
    return 10.0 * math.log10(peak * peak / mse)


def frame_psnr_yuv(a: np.ndarray, b: np.ndarray, width: int, height: int):
    """(Y, U, V) PSNR of packed I420 frames."""
    ysz = width * height
    return (psnr(a[:ysz], b[:ysz]),
            psnr(a[ysz:ysz + ysz // 4], b[ysz:ysz + ysz // 4]),
            psnr(a[ysz + ysz // 4:ysz + ysz // 2],
                 b[ysz + ysz // 4:ysz + ysz // 2]))
