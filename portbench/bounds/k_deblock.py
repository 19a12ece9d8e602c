"""Frame deblock (csrc/deblock_wavefront.cuh, launched for the GOP
kernel's, the scan's and the encoder's pictures): the three PAD-padded
int32 planes read and written and the (gh, gw, 62) int16 parameter rows
read, per launch (``chip_smoke.deblock_bound``, chip_smoke.py:336-345;
its operations term, about 30 a filtered line, is left out: at these
sizes it is under a twentieth of the bytes term, so the bound is the
bytes' whatever the bS maps hold)."""
from portbench.bounds import grid, launches, padded, seconds


def least_seconds(trace):
    gw, gh = grid(trace)
    Hp, Wp, Hcp, Wcp = padded(gw, gh)
    per = seconds(2 * 4 * (Hp * Wp + 2 * Hcp * Wcp) + gw * gh * 62 * 2)
    return launches(trace, "k_deblock") * per
