"""Where ``k_p_residual``'s time goes: variants of its source, timed alone
on one card.

    python tools/port_residual_variants.py [--clock] [NAME ...]

Each variant is this tree's ``hartallo_tpu_torch`` copied under
``build/variants/NAME`` with text substitutions in ``csrc/p_encode.cu``
(``VARIANTS``): the tree as it is; at most 64, 56 and 51 registers a
thread through ``__launch_bounds__`` (32, 36 and 40 warps an SM); the
prediction cut to a copy of window samples, without the row
sums; the intra-in-P SATDs left out; the recon left unwritten.  All but
the first compute wrong outputs on purpose, so the tool holds nothing
against a twin: it only times.  Each variant builds and runs in a
process of its own (``--time DIR``), in the order given (default: every
variant, then the tree again), and prints one JSON line: the card's name
and power limit, ptxas' registers and spills of ``k_p_residual``, and the
kernel alone (``chip_smoke.kernel_us``, the profiler's device time) at
one MB, CIF, 720p and 1080p on the MVs the path derives from the search
and refinement (``chip_smoke.P_CASES``).  ``--clock`` first samples the
SM clock and the power draw (``nvidia-smi``) while 1080p calls of the
tree's kernel run back to back.  Needs a CUDA device.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import sys
import threading
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
KERNEL = "__global__ void __launch_bounds__(PR_THREADS) k_p_residual"
VARIANTS = {
    "tree": [],
    "registers_64": [(KERNEL, KERNEL.replace("(PR_THREADS)",
                                             "(PR_THREADS, 8)"))],
    "registers_56": [(KERNEL, KERNEL.replace("(PR_THREADS)",
                                             "(PR_THREADS, 9)"))],
    "registers_51": [(KERNEL, KERNEL.replace("(PR_THREADS)",
                                             "(PR_THREADS, 10)"))],
    "no_prediction": [
        ("    if ((split & quad_lanes(q)) == 0) {\n      const int iy0",
         "    if (true) {\n      for (int k = 0; k < 8; ++k) pred[k] = "
         "w[k];\n    } else if ((split & quad_lanes(q)) == 0) {\n"
         "      const int iy0"),
        ("  if (sfx != 0) {", "  if (false) {")],
    "no_satd": [("  if (a.mask) {\n    int s = 0;",
                 "  if (false) {\n    int s = 0;")],
    "no_recon": [("      st4(a.oy + (size_t)", "      if (a.gw < 0) "
                  "st4(a.oy + (size_t)"),
                 ("    st4((comp ? a.ov : a.ou)", "    if (a.gw < 0) "
                  "st4((comp ? a.ov : a.ou)"),
                 ("  if (edge) {                    // warp-uniform",
                  "  if (edge && a.gw < 0) {")],
}
TIMED = ("one MB", "CIF", "720p", "1080p")


def make(name: str) -> pathlib.Path:
    """build/variants/NAME: the package with NAME's substitutions."""
    out = REPO / "build" / "variants" / name
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(REPO / "hartallo_tpu_torch", out / "hartallo_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = out / "hartallo_tpu_torch" / "csrc" / "p_encode.cu"
    text = cu.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} is not in p_encode.cu once")
        text = text.replace(old, new)
    cu.write_text(text)
    return out


def path_inputs(torch, k: int):
    """P_CASES[k] on the card with the path's MVs: (gw, gh, the residual
    wrapper's arguments and keywords)."""
    import chip_smoke as CS
    from hartallo_tpu_torch.encode import me_fast as MF
    from hartallo_tpu_torch.encode import p_body_fast as PB
    _, gw, gh, t = CS.p_case_tensors(torch, k)
    src, ref, lam = t["src"], t["ref"], t["lam"]
    fs = MF.full_search_int_fast(src[0], ref[0], lam, gw=gw, gh=gh,
                                 rng=t["rng"])
    _, best, mv, part = PB.partition_decide_fast(fs, lam, gw=gw, gh=gh)
    mv = MF.refine_subpel_rounds_fast(
        src[0], ref[0], mv, part, lam, (2, 1), gw=gw, gh=gh, nparts=4,
        hp=PB.halfpel_planes_fast(ref[0]))[0]
    return gw, gh, (*src, *ref, mv, t["qp"], best, lam), dict(
        gw=gw, gh=gh, chroma_qp_off=t["cqo"], intra_in_p=True)


def clock(torch) -> list:
    """nvidia-smi's SM clock, highest SM clock and power draw, sampled
    while 1080p residual calls run back to back."""
    import chip_smoke as CS
    from hartallo_tpu_torch.encode import p_body_fast as PB
    k = next(i for i, c in enumerate(CS.P_CASES) if c[0] == "1080p")
    _, _, args, kw = path_inputs(torch, k)
    samples = []

    def sample():
        for _ in range(6):
            time.sleep(0.3)
            samples.append(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,"
                 "power.draw", "--format=csv,noheader"],
                capture_output=True, text=True).stdout.strip())
    th = threading.Thread(target=sample)
    th.start()
    while th.is_alive():
        for _ in range(50):
            PB.p_residual_fast(*args, **kw)
    torch.cuda.synchronize()
    return samples


def time_tree(tree: str, with_clock: bool) -> None:
    sys.path.insert(0, str(REPO))
    import torch
    import chip_smoke as CS
    sys.path.insert(0, str(pathlib.Path(tree).resolve()))
    from hartallo_tpu_torch import kernels
    from hartallo_tpu_torch.encode import p_body_fast as PB
    if not torch.cuda.is_available():
        raise SystemExit("port_residual_variants: torch sees no CUDA device")
    kernels.build()
    res = {"card": CS.card_line(), "variant": pathlib.Path(tree).name,
           "kernel_us": {}}
    log = kernels.BUILD_LOG.splitlines()
    for i, line in enumerate(log):
        if "k_p_residual" in line and "Compiling entry" in line:
            res["ptxas"] = " | ".join(s.strip() for s in log[i + 1:i + 3])
    if with_clock:
        res["clock"] = clock(torch)
    for k, (label, *_) in enumerate(CS.P_CASES):
        if label in TIMED:
            _, _, args, kw = path_inputs(torch, k)
            res["kernel_us"][label] = CS.kernel_us(
                torch, lambda: PB.p_residual_fast(*args, **kw), 20,
                "k_p_residual")
    print(json.dumps(res), flush=True)


def main(argv) -> None:
    if argv[:1] == ["--time"]:
        time_tree(argv[1], "--clock" in argv)
        return
    names = [a for a in argv if not a.startswith("--")] or \
        [*VARIANTS, "tree"]
    for i, name in enumerate(names):
        cmd = [sys.executable, __file__, "--time", str(make(name))]
        if "--clock" in argv and i == 0:
            cmd.append("--clock")
        subprocess.run(cmd, check=True)


if __name__ == "__main__":
    main(sys.argv[1:])
