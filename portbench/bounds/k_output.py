"""GOP kernel (csrc/d_gop.cu), its output launch: the picture's I420 bytes
written (``chip_smoke.gop_bound``, chip_smoke.py:315-333, its
(H + H / 2) W term)."""
from portbench.bounds import route, seconds


def least_seconds(trace):
    return sum(seconds(p["gh"] * 16 * p["gw"] * 16 * 3 // 2)
               for p in route(trace, "kernel"))
