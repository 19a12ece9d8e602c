"""The deblock's parameter rows and filter as plain torch: the frozen
copy of the port's ``ops/deblock_fast`` twins, with the CUDA launches
left out (the reference runs on the CPU alone).

``pack_deblock_record`` lays a picture's per-MB fields out as the int16
record the decoder parses into; ``deblock_params_dec_plain`` turns
records into the (K, gh, gw, NAUX) int16 parameter rows (bS, alpha,
beta, tc0 of every edge); ``edge_rows`` is the end of that chain, which
the encoder's in-loop deblock shares; ``deblock_frame_aux_plain`` filters
PAD-padded planes with such rows.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.h264.core import tables as T
from portbench.reference.h264.ops.deblock import deblock_filter, edge_params
from portbench.reference.h264.ops.wide import compute_bs_grids

NAUX = 62
# The per-MB int16 words the decoder's deblock parameters read, as
# (name, shape) in the order of ``d_fused.DEC_FIELDS`` (where the GOP
# scan's dense buffer holds them, among others); the general route packs
# a record of these alone (``pack_deblock_record``).
DEBLOCK_FIELDS = (("kind", ()), ("qp", ()), ("mv", (4, 4, 2)),
                  ("ref_idx", (4,)), ("nnz", (4, 4)), ("alpha_off", ()),
                  ("beta_off", ()), ("fmb_v", ()), ("fmb_h", ()),
                  ("fint", ()))


def record_offsets(fields, wanted=DEBLOCK_FIELDS) -> tuple:
    """The word offsets of the ``wanted`` fields in a record laid out as
    ``fields`` ((name, shape) pairs, one after another), and the record's
    words: ((an offset a wanted field), words)."""
    offs, o = {}, 0
    for name, shape in fields:
        offs[name] = o
        o += int(np.prod(shape, dtype=int)) if shape else 1
    return tuple(offs[name] for name, _ in wanted), o


# each field's words
_SIZES = tuple(int(np.prod(shape, dtype=int)) if shape else 1
               for _, shape in DEBLOCK_FIELDS)
# the offsets of ``pack_deblock_record``'s record, and its words: the
# fields and one zero word, so that a record is 8-byte vectors (the
# kernel stages records as such)
RECORD_OFFSETS, _FIELD_WORDS = record_offsets(DEBLOCK_FIELDS)
RECORD_WORDS = (_FIELD_WORDS + 3) // 4 * 4


def pack_deblock_record(values: dict, gw: int, gh: int) -> np.ndarray:
    """Host: the (gh*gw, RECORD_WORDS) int16 record of ``DEBLOCK_FIELDS``
    from numpy arrays of shape (gh, gw) + the field's shape (``nnz`` per
    MB in raster order of its 4x4 blocks), zeros after the fields."""
    rec = np.zeros((gh * gw, RECORD_WORDS), np.int16)
    for (name, _), o, n in zip(DEBLOCK_FIELDS, RECORD_OFFSETS, _SIZES):
        rec[:, o:o + n] = np.asarray(values[name]).reshape(gh * gw, n)
    return rec


def check_record(name: str, rec, gw: int, gh: int, offsets,
                 fields) -> None:
    """Raise ``ValueError`` unless rec is a contiguous int16 (K, gh*gw,
    words) tensor and ``offsets`` has one offset for each of
    ``fields``."""
    if not isinstance(rec, torch.Tensor) or rec.dtype != torch.int16 or \
            not rec.is_contiguous() or rec.dim() != 3 or \
            rec.shape[1] != gh * gw or len(offsets) != len(fields):
        got = f"{getattr(rec, 'dtype', type(rec))} " \
            f"{tuple(getattr(rec, 'shape', ()))}"
        raise ValueError(f"{name}: rec {got}; it needs a contiguous int16 "
                         f"(K, {gh * gw}, words) tensor and {len(fields)} "
                         "offsets")


def deblock_params_dec_plain(rec, offsets, chroma_qp_off: int, *, gw: int,
                             gh: int):
    """The decoder's deblock parameters: the eager chain of
    the GOP scan and the general route, ``compute_bs_grids`` (I4x4, I16,
    PCM and I_BL intra), the left and top QP and chroma QP maps (the edge
    MB its own) and ``edge_params`` with the per-MB offsets, batched over
    the K pictures, on the int16 records' fields widened to int32.
    Returns (K, gh, gw, NAUX) int16."""
    check_record("deblock_params_dec_plain", rec, gw, gh, offsets,
                 DEBLOCK_FIELDS)
    K = rec.shape[0]
    f = {}
    for (name, shape), o in zip(DEBLOCK_FIELDS, offsets):
        n = int(np.prod(shape, dtype=int)) if shape else 1
        f[name] = rec[:, :, o:o + n].to(torch.int32).reshape(
            (K, gh, gw) + shape)
    kind = f["kind"]
    nnz = f["nnz"].permute(0, 1, 3, 2, 4).reshape(K, 4 * gh, 4 * gw)
    mvg = f["mv"].permute(0, 1, 3, 2, 4, 5).reshape(K, 4 * gh, 4 * gw, 2)
    ref44 = f["ref_idx"].reshape(K, gh, gw, 2, 2) \
        .repeat_interleave(2, 3).repeat_interleave(2, 4)
    refg = ref44.permute(0, 1, 3, 2, 4).reshape(K, 4 * gh, 4 * gw)
    bs_vg, bs_hg = compute_bs_grids((kind <= 2) | (kind == 8), nnz, mvg,
                                    refg, f["fmb_v"] != 0, f["fmb_h"] != 0,
                                    f["fint"] != 0)
    return edge_rows(bs_vg.reshape(K, gh, 4, gw, 4).permute(0, 1, 3, 4, 2),
                     bs_hg.reshape(K, gh, 4, gw, 4).permute(0, 1, 3, 2, 4),
                     f["qp"], chroma_qp_off, f["alpha_off"], f["beta_off"])


def edge_rows(bs_v, bs_h, qp, chroma_qp_off: int, alpha_off, beta_off):
    """``edge_params`` of K pictures as (K, gh, gw, NAUX) int16 rows, the
    end of both deblock parameter chains (the decoder's and the encoder's): bs_v, bs_h (K, gh,
    gw, 4, 4), qp and the slices' offsets (K, gh, gw).  The left and top
    MBs' QP and chroma QP maps are made here, the edge MB its own."""
    K, gh, gw = qp.shape
    qp = qp.to(torch.int32)
    qpc = torch.as_tensor(np.asarray(T.QP_SCALE_CHROMA, np.int32))[
        torch.clamp(qp + chroma_qp_off, 0, 51).long()]

    def left(a):
        return torch.cat([a[:, :, :1], a[:, :, :-1]], dim=2)

    def top(a):
        return torch.cat([a[:, :1], a[:, :-1]], dim=1)

    def rows(a):
        return a.reshape((K * gh, gw) + a.shape[3:])
    aux = edge_params(rows(bs_v), rows(bs_h),
                      *map(rows, (qp, left(qp), top(qp), qpc, left(qpc),
                                  top(qpc), alpha_off, beta_off)))
    return aux.reshape(K, gh, gw, NAUX).to(torch.int16)


def deblock_frame_aux_plain(planes, aux, *, gw: int, gh: int):
    """``deblock_filter`` on copies of the planes, with the parameter
    rows ``aux``."""
    return deblock_filter(tuple(p.to(torch.int32).clone() for p in planes),
                          aux, gw=gw, gh=gh)
