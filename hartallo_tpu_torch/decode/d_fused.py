"""Dense per-MB decode buffer of the GOP scan (numpy, host).

Copy of ``DEC_FIELDS`` and ``pack_slice_arrays`` from
``hartallo_tpu/decode/d_fused.py``, whose other contents import jax.
``decode_gop`` consumes the (gh*gw, WORDS) int16 rows this builds; the
decoder writes them with ``pack_slice_rows`` straight into its staging
buffer (``decode/staging.py``), ``pack_slice_arrays`` being its twin.
"""
from __future__ import annotations

import numpy as np

# packed layout: (name, trailing shape) — per-MB int32 words
DEC_FIELDS = [
    ("luma_ac", (16, 4, 4)), ("luma_dc", (4, 4)),
    ("chroma_ac", (2, 4, 4, 4)), ("chroma_dc", (2, 2, 2)),
    ("qp", ()), ("kind", ()), ("i16_mode", ()), ("i4_modes", (16,)),
    ("chroma_mode", ()), ("mv", (4, 4, 2)), ("ref_idx", (4,)),
    ("nnz", (4, 4)), ("alpha_off", ()), ("beta_off", ()),
    ("avail_l", ()), ("avail_t", ()), ("avail_tr", ()),
    ("fmb_v", ()), ("fmb_h", ()), ("fint", ()),
    # explicit weighted prediction (8.4.2.3.2): per 8x8 partition
    # [w, o, logWD] for luma and per plane for chroma; identity when the
    # slice has no pred_weight_table (w=1, o=0, logWD=0)
    ("wp_l", (4, 3)), ("wp_c", (4, 2, 3)),
]


def pack_slice_arrays(sd, al, at, fmb_v, fmb_h, fint,
                      wp_l=None, wp_c=None, atr=None) -> np.ndarray:
    """Host: SliceData + availability/filter masks -> (gh*gw, W) int16."""
    gh, gw = sd.gh, sd.gw
    n = gh * gw
    if wp_l is None:
        wp_l = np.zeros((gh, gw, 4, 3), np.int32)
        wp_l[..., 0] = 1
    if wp_c is None:
        wp_c = np.zeros((gh, gw, 4, 2, 3), np.int32)
        wp_c[..., 0] = 1
    nnz_mb = sd.nnz_luma.reshape(gh, 4, gw, 4).transpose(0, 2, 1, 3)
    vals = {
        "luma_ac": sd.luma_ac, "luma_dc": sd.luma_dc,
        "chroma_ac": sd.chroma_ac, "chroma_dc": sd.chroma_dc,
        "qp": sd.qp, "kind": sd.mb_kind, "i16_mode": sd.i16_mode,
        "i4_modes": sd.i4_modes, "chroma_mode": sd.chroma_mode,
        "mv": sd.mv, "ref_idx": sd.ref_idx, "nnz": nnz_mb,
        "alpha_off": sd.alpha_off, "beta_off": sd.beta_off,
        "avail_l": al, "avail_t": at,
        "avail_tr": (np.ones((gh, gw), bool) if atr is None else atr),
        "fmb_v": fmb_v, "fmb_h": fmb_h, "fint": fint,
        "wp_l": wp_l, "wp_c": wp_c,
    }
    # int16 transfer buffer: every field fits (spec A.2.1 bounds
    # coefficient values to [-2^15, 2^15-1]; quarter-pel MVs to +-8192)
    # and the host->device copy halves
    parts = []
    for name, shape in DEC_FIELDS:
        w = int(np.prod(shape, dtype=int)) if shape else 1
        parts.append(np.ascontiguousarray(
            vals[name], dtype=np.int16).reshape(n, w))
    return np.concatenate(parts, axis=1)


def pack_slice_rows(sd, al, at, fmb_v, fmb_h, fint, wp_l=None, wp_c=None,
                    atr=None, *, out: np.ndarray) -> np.ndarray:
    """``pack_slice_arrays``' rows written straight into ``out`` (gh*gw,
    WORDS) int16 (a row of the decoder's page-locked staging buffer), each
    field cast to int16 as there, with no intermediate array; returns
    out.  ``pack_slice_arrays`` is its twin."""
    gh, gw = sd.gh, sd.gw
    n = gh * gw
    if wp_l is None:
        wp_l = np.zeros((gh, gw, 4, 3), np.int32)
        wp_l[..., 0] = 1
    if wp_c is None:
        wp_c = np.zeros((gh, gw, 4, 2, 3), np.int32)
        wp_c[..., 0] = 1
    nnz_mb = sd.nnz_luma.reshape(gh, 4, gw, 4).transpose(0, 2, 1, 3)
    vals = {
        "luma_ac": sd.luma_ac, "luma_dc": sd.luma_dc,
        "chroma_ac": sd.chroma_ac, "chroma_dc": sd.chroma_dc,
        "qp": sd.qp, "kind": sd.mb_kind, "i16_mode": sd.i16_mode,
        "i4_modes": sd.i4_modes, "chroma_mode": sd.chroma_mode,
        "mv": sd.mv, "ref_idx": sd.ref_idx, "nnz": nnz_mb,
        "alpha_off": sd.alpha_off, "beta_off": sd.beta_off,
        "avail_l": al, "avail_t": at,
        "avail_tr": (np.ones((gh, gw), bool) if atr is None else atr),
        "fmb_v": fmb_v, "fmb_h": fmb_h, "fint": fint,
        "wp_l": wp_l, "wp_c": wp_c,
    }
    o = 0
    for name, shape in DEC_FIELDS:
        w = int(np.prod(shape, dtype=int)) if shape else 1
        out[:, o:o + w] = np.asarray(vals[name]).reshape(n, w).astype(
            np.int16, copy=False)
        o += w
    return out
