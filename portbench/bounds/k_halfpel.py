"""GOP kernel (csrc/d_gop.cu), its half-pel launch: the ring slot's four
luma planes of bytes written, 36 operations a padded luma sample (the
6-tap filters of b, h and j) (``chip_smoke.gop_bound``,
chip_smoke.py:315-333, its 4 Hp Wp and 36 Hp Wp terms)."""
from portbench.bounds import padded, route, seconds


def least_seconds(trace):
    total = 0.0
    for p in route(trace, "kernel"):
        Hp, Wp, _, _ = padded(p["gw"], p["gh"])
        total += seconds(4 * Hp * Wp, 36 * Hp * Wp)
    return total
