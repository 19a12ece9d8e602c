"""The GOP kernel route's share of its roofline: the least time of its
launches' work on the window's pictures (``bounds/``: the GOP kernel's
MC, residual, intra, half-pel, chroma and output launches and the frame
deblock) over their summed device time in the profiler's trace."""
from portbench.capture import DECODE_HOOKS

HOOKS = DECODE_HOOKS
KERNELS = ("k_mc", "k_residual", "k_intra", "k_halfpel", "k_pad_chroma",
           "k_output", "k_deblock")


def read(trace):
    if not any(p.get("route") == "kernel" for p in trace.pictures):
        return None
    return trace.roofline_pct(KERNELS)
