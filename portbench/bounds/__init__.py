"""The least time of each device kernel's work in a traced window.

``bounds/<kernel>.py``, named by the kernel's name in the device trace
(``k_mc_dec<unsigned char>(...)`` is ``k_mc_dec``), defines
``least_seconds(trace)``: the least time the card could take for that
kernel's work on the window's pictures, each input byte read once and
each output byte written once, and its operations at the peak rate.
The counts are copied from ``chip_smoke.py``'s ``*_bound`` functions
(line numbers in each file) so that later changes to the smoke do not
move them.  Where the work depends on the data, a file counts what the
window's pictures need (their intra and inter MBs, coded blocks), as the
capture hooks recorded them; where a picture's count is not known, it
counts nothing for it, so a share is never overstated.

Peaks: NVIDIA's H100 SXM data sheet, at the 700 W power limit: 3.35 TB/s
of HBM3 and 67 TFLOP/s of float32 outside the tensor cores, the nearest
published rate for the kernels' int32 arithmetic.
"""
from __future__ import annotations

from portbench import harness

HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
PAD = 32


def seconds(nbytes: float, ops: float = 0.0,
            ops_per_s: float = SCALAR_OPS_PER_S) -> float:
    """The larger of the bytes' and the operations' least times."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)


def grid(trace):
    """(gw, gh) of the cell's pictures."""
    c = trace.config
    return (c["width"] + 15) // 16, (c["height"] + 15) // 16


def padded(gw: int, gh: int):
    """(Hp, Wp, Hcp, Wcp): the PAD-padded luma and chroma plane sizes."""
    return gh * 16 + 2 * PAD, gw * 16 + 2 * PAD, gh * 8 + 2 * PAD, \
        gw * 8 + 2 * PAD


def launches(trace, kernel: str) -> int:
    return trace.kernels.get(kernel, (0.0, 0))[1]


def route(trace, name: str):
    return [p for p in trace.pictures if p.get("route") == name]


def least_seconds(kernel: str, trace) -> float:
    mod = harness.bound_module(kernel)
    return 0.0 if mod is None else mod.least_seconds(trace)

