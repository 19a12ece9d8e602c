"""GOP kernel (csrc/d_gop.cu), its MC launch: each kernel-route picture's
MC words and frame fields read, and one reference sample per predicted
sample of its inter MBs (``chip_smoke.gop_bound``, chip_smoke.py:315-333,
its smb, sf and (nmb - ni) * 384 terms)."""
from portbench.bounds import route, seconds


def least_seconds(trace):
    return sum(seconds(p["smb_bytes"] + 32 +
                       (p["gw"] * p["gh"] - p["ni"]) * 384)
               for p in route(trace, "kernel") if p["gw"] * p["gh"] > p["ni"])
