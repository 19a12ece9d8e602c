"""GOP kernel (csrc/d_gop.cu), its chroma launch: the ring slot's two
padded chroma planes of bytes written (``chip_smoke.gop_bound``,
chip_smoke.py:315-333, its 2 Hcp Wcp term)."""
from portbench.bounds import padded, route, seconds


def least_seconds(trace):
    total = 0.0
    for p in route(trace, "kernel"):
        _, _, Hcp, Wcp = padded(p["gw"], p["gh"])
        total += seconds(2 * Hcp * Wcp)
    return total
