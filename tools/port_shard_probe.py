"""Where the time of the port's sharded decode goes, on a CUDA device.

    python tools/port_shard_probe.py

Builds the kernels, then decodes ``tests/data/port/shard_1080p_8.264``
twice with ``decode_gops_grouped`` on ``Mesh(("cuda:0",) * 4)`` in 2
groups, printing each decode's seconds and the seconds of every call of
the band intra wavefront (``intra_reconstruct_fast``, one kernel launch,
synchronised around each call), every frame held to its MD5; then runs
``chip_smoke.py``'s scan phase, shard phase and shard rates, printing
the seconds of each.
"""
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "tools"), str(REPO / "tests")]


def main() -> None:
    import torch

    import chip_smoke as C
    from hartallo_tpu_torch import kernels
    from hartallo_tpu_torch.decode import d_gop as G
    from hartallo_tpu_torch.parallel.shard import Mesh, decode_gops_grouped
    t0 = time.perf_counter()
    kernels.build()
    print("build", time.perf_counter() - t0, flush=True)
    print(C.card_line(), flush=True)
    stream, meta = C.load_fixture(C.SHARD)
    real = G.intra_reconstruct_fast
    log = []

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = real(*args, **kw)
        torch.cuda.synchronize()
        log.append(round((time.perf_counter() - t) * 1e3, 3))
        return r
    G.intra_reconstruct_fast = timed
    for i in range(2):
        log.clear()
        t = time.perf_counter()
        fr = decode_gops_grouped(Mesh(("cuda:0",) * 4), stream, groups=2)
        torch.cuda.synchronize()
        print(f"sharded decode {i}: {time.perf_counter() - t:.2f} s, "
              f"band intra calls (ms) {log}", flush=True)
        if [C.frame_md5(f) for f in fr] != meta["frame_md5"]:
            raise SystemExit("the sharded decode misses the MD5s")
    G.intra_reconstruct_fast = real
    t = time.perf_counter()
    C.scan_phase(torch)
    print(f"scan_phase {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    planes = C.shard_phase(torch)[3]
    print(f"shard_phase {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    C.shard_rates(torch, C.card_line(), planes)
    print(f"shard_rates {time.perf_counter() - t:.1f} s", flush=True)


if __name__ == "__main__":
    main()
