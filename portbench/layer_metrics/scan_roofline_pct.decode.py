"""The GOP scan route's share of its roofline: the least time of the scan
kernels' work on the window's pictures (``bounds/``: residual, deblock
parameters, MC, intra wavefront, frame deblock, ring write) over their
summed device time in the profiler's trace."""
from portbench.capture import DECODE_HOOKS

HOOKS = DECODE_HOOKS
KERNELS = ("k_residual_dec", "k_deblock_params_dec", "k_mc_dec",
           "k_intra_decode", "k_deblock", "k_ring_write_dec")


def read(trace):
    if not any(p.get("route") == "scan" for p in trace.pictures):
        return None
    return trace.roofline_pct(KERNELS)
