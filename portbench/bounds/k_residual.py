"""GOP kernel (csrc/d_gop.cu), its residual launch: each coded block's tag
and 16 int16 levels read once (``chip_smoke.gop_bound``,
chip_smoke.py:315-333, its nr * (4 + 16 * 2) term)."""
from portbench.bounds import route, seconds


def least_seconds(trace):
    return sum(seconds(p["nr"] * (4 + 16 * 2))
               for p in route(trace, "kernel"))
