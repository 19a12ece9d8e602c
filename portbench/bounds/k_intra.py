"""GOP kernel (csrc/d_gop.cu), its intra launch: each intra MB's entry and
its 24 blocks of 16 int16 levels read once (``chip_smoke.gop_bound``,
chip_smoke.py:315-333, its ni * (16 + 24 * 16 * 2) term)."""
from portbench.bounds import route, seconds


def least_seconds(trace):
    return sum(seconds(p["ni"] * (16 + 24 * 16 * 2))
               for p in route(trace, "kernel"))
