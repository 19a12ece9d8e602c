"""GOP scan's MC (csrc/mc_decode.cu) on the scan's byte ring: the three
padded int32 planes written, and for each inter MB its residual, its
blocks' MVs, slots and weights and one reference byte a predicted
sample read, the inter mask read; 10 operations a predicted sample
(``chip_smoke.mc_dec_bound``, chip_smoke.py:1185-1196, elem 1).  A scan
picture with no inter MB counts nothing."""
from portbench.bounds import padded, route, seconds


def least_seconds(trace):
    total = 0.0
    for p in route(trace, "scan"):
        n_inter = p["n_inter"]
        if not n_inter:
            continue
        Hp, Wp, Hcp, Wcp = padded(p["gw"], p["gh"])
        out = 4 * (Hp * Wp + 2 * Hcp * Wcp)
        total += seconds(out + n_inter * (384 * 4 + 16 * 12 * 4 + 384) +
                         p["gw"] * p["gh"], 10 * 384 * n_inter)
    return total
