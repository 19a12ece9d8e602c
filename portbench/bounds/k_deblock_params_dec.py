"""The decoder's deblock parameters (csrc/deblock.cu): 59 int16 words of
each MB's record read, 62 written, about 40 operations a 4x4 block
(``chip_smoke.params_dec_bound``, chip_smoke.py:1141-1147), for each scan
picture."""
from portbench.bounds import route, seconds


def least_seconds(trace):
    return sum(seconds(p["gw"] * p["gh"] * (59 * 2 + 62 * 2),
                       40 * 16 * p["gw"] * p["gh"])
               for p in route(trace, "scan"))
