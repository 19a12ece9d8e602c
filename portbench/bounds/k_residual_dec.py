"""GOP scan's residual (csrc/mc_decode.cu): of each scan picture's int16
records, what its MBs need read once (qp, kind, nnz, chroma levels and
DC; an I16 MB's luma DC; the 16 levels of each luma block whose
TotalCoeff is above 0), its 384 int32 residual samples an MB written,
12 operations a sample (``chip_smoke.residual_dec_bound``,
chip_smoke.py:1157-1173)."""
from portbench.bounds import route, seconds


def least_seconds(trace):
    total = 0.0
    for p in route(trace, "scan"):
        n = p["gw"] * p["gh"]
        read = 2 * (n * (1 + 1 + 16 + 128 + 8) + 16 * p["n_i16"] +
                    16 * p["coded_luma_blocks"])
        total += seconds(read + n * 384 * 4, 12 * 384 * n)
    return total
