"""GOP scan's ring write (csrc/mc_decode.cu): the three deblocked int32
interiors read, the slot's four half-pel luma planes and two padded
chroma planes of bytes and the picture's I420 output row written; 36
operations a padded luma sample (``chip_smoke.ring_write_bound``,
chip_smoke.py:1199-1210, with the slot at the padded picture's size)."""
from portbench.bounds import padded, route, seconds


def least_seconds(trace):
    total = 0.0
    for p in route(trace, "scan"):
        H, W = p["gh"] * 16, p["gw"] * 16
        Hp, Wp, Hcp, Wcp = padded(p["gw"], p["gh"])
        total += seconds(4 * H * W * 3 // 2 + 4 * Hp * Wp + 2 * Hcp * Wcp +
                         H * W * 3 // 2, 36 * Hp * Wp)
    return total
