"""The decoder's intra wavefront (csrc/intra_decode.cu), on each scan
picture with an intra MB: its new padded int32 planes written, the input
planes read but the intra MBs' samples, the intra MBs' residuals and
modes (406 words an MB) and the other MBs' kinds read; 8 operations a
predicted sample (``chip_smoke.intra_dec_bound``,
chip_smoke.py:1118-1131)."""
from portbench.bounds import padded, route, seconds


def least_seconds(trace):
    total = 0.0
    for p in route(trace, "scan"):
        n = p["n_intra"]
        if not n:
            continue
        Hp, Wp, Hcp, Wcp = padded(p["gw"], p["gh"])
        planes = 4 * (Hp * Wp + 2 * Hcp * Wcp)
        read = planes - 4 * 384 * n
        total += seconds(planes + read + n * 406 * 4 +
                         (p["gw"] * p["gh"] - n) * 4, 8 * 384 * n)
    return total
