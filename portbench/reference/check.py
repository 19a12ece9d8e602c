"""The reference side of a run's check, run in worker processes.

Each worker imports this module, the frozen copy ``h264`` and torch, and
nothing of the program: it is started with the ``spawn`` method and
given only the stream, the clip and the program's outputs as bytes and
arrays.  ``decode_chain`` returns what the run holds against the program's
outputs.
"""
from __future__ import annotations

import time

import numpy as np

_STATE = {}


def init(threads: int, stream: bytes = None) -> None:
    """Worker set-up: the torch threads it may use, and the segment's
    stream, which the program decodes, split into pictures once."""
    import torch
    torch.set_num_threads(max(1, threads))
    if stream is not None:
        from portbench.reference.decode import split_stream
        try:
            _STATE["stream"] = split_stream(stream)
        except Exception as e:                          # noqa: BLE001
            _STATE["stream"] = e


def _stream():
    s = _STATE.get("stream")
    if isinstance(s, Exception) or s is None:
        raise ValueError(f"the segment's stream does not parse: {s}")
    return s


def max_abs_diff(a: np.ndarray, b: np.ndarray) -> int:
    """The widest gap between two frames' samples; a frame of another
    size, or none, counts as 256."""
    if a is None or b is None or a.shape != b.shape:
        return 256
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def decode_chain(k: int, base, programs, control: bool = False) -> dict:
    """Picture ``k`` of the segment and, where it is a P picture, the
    picture before it: k - 1 decoded by the reference from ``base`` (the
    program's frame k - 2; None where k - 1 is the IDR picture), then k
    from the reference's own frame k - 1; an IDR picture alone, from
    nothing.  ``programs``: the program's frames of those pictures, in
    order.  Returns the widest gap of each picture.  With ``control``
    the control decodes in the program's place, from the same ``base``
    and then from its own frames, and its gaps come beside."""
    from portbench.reference.decode import decode_picture
    t = time.perf_counter()
    out = {"k": k, "pictures": [], "max_abs_diff": [],
           "control_max_abs_diff": []}
    try:
        sps, pps, pictures = _stream()
        ks = [k] if pictures[k].idr else [k - 1, k]
        ref = cref = base
        for kk, program in zip(ks, programs[-len(ks):]):
            idr = pictures[kk].idr
            want = decode_picture(pictures[kk], sps, pps,
                                  None if idr else ref)
            out["pictures"].append(kk)
            out["max_abs_diff"].append(max_abs_diff(program, want))
            if control:
                got = decode_picture(pictures[kk], sps, pps,
                                     None if idr else cref, control=True)
                out["control_max_abs_diff"].append(max_abs_diff(got, want))
                cref = got
            ref = want
    except (ValueError, IndexError) as e:
        out["error"] = f"{type(e).__name__}: {e}"[:300]
        out["max_abs_diff"].append(256)
        if control:
            out["control_max_abs_diff"].append(256)
    out["seconds"] = time.perf_counter() - t
    return out
