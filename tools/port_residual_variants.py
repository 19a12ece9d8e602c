"""Where a residual or deblock-parameter kernel's time goes: variants of
its source, timed alone on one card.

    python tools/port_residual_variants.py [--clock] [NAME ...]
    python tools/port_residual_variants.py --dec [NAME ...]

Each variant is this tree's ``hartallo_tpu_torch`` copied under
``build/variants/NAME`` with text substitutions in one source of
``csrc/`` (``VARIANTS``: NAME -> (source, substitutions)).  Each builds
and runs in a process of its own (``--time DIR``), in the order given
(default: every variant of the family, then its tree again), and prints
one JSON line with the card's name and power limit and ptxas' registers
and spills of the kernels it times.  Variants that leave work out
compute wrong outputs on purpose, so the tool holds nothing against a
twin: it only times.  Needs a CUDA device.

The encoder's family (the default), ``k_p_residual`` in ``p_encode.cu``:
the tree as it is; at most 64, 56 and 51 registers a thread through
``__launch_bounds__`` (32, 36 and 40 warps an SM); the prediction cut to
a copy of window samples, without the row sums; the intra-in-P SATDs
left out; the recon left unwritten.  Timed alone
(``chip_smoke.kernel_us``, the profiler's device time) at one MB, CIF,
720p and 1080p on the MVs the path derives from the search and
refinement (``chip_smoke.P_CASES``).  ``--clock`` first samples the SM
clock and the power draw (``nvidia-smi``) while 1080p calls of the
tree's kernel run back to back.

The decoder's family (``--dec``), ``k_residual_dec`` in ``mc_decode.cu``
and ``k_deblock_params_dec`` in ``deblock.cu``: the tree as it is
(``dec_tree``); the residual with at most 32 or 40 registers a thread
(32 or 24 blocks of 64 threads an SM), blocks of 128 threads (8 MBs),
its stores left out, its luma levels left unread; the parameter kernel
with its threshold tables read from global memory instead of staged,
the row above read from global memory instead of staged, strips of 16
or 32 MBs a block (correct outputs, other designs), its outputs left
unwritten, its body left out (the launch alone, with its grid and shared
memory).  Both kernels timed alone (``chip_smoke.kernel_us``: a cold L2,
the median) on one picture's int16 record at CIF, 720p, 1080p and the
120x34 band: the residual on ``chip_smoke.residual_rec_inputs``' mixed,
zero-coded and fully coded sets, the parameters on the scan's dense
buffer (``deblock_rec_inputs(wide=True)``).
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
RD_KERNEL = "__global__ void __launch_bounds__(RD_THREADS) k_residual_dec"
RD_STORES = "    st4(o + i * stride, make_int4("
RD_LUMA = "!(t < 64 ? s[RS_NNZ + blk_raster(t >> 2)] > 0 : s[RS_KIND] == 1)"
DD_MBS = "constexpr int DD_MBS = 8; "
DD_TAB = "  if (threadIdx.x < DD_TAB_WORDS / 4)\n"
VARIANTS = {
    "tree": ("p_encode.cu", []),
    "registers_64": ("p_encode.cu", [(KERNEL, KERNEL.replace(
        "(PR_THREADS)", "(PR_THREADS, 8)"))]),
    "registers_56": ("p_encode.cu", [(KERNEL, KERNEL.replace(
        "(PR_THREADS)", "(PR_THREADS, 9)"))]),
    "registers_51": ("p_encode.cu", [(KERNEL, KERNEL.replace(
        "(PR_THREADS)", "(PR_THREADS, 10)"))]),
    "no_prediction": ("p_encode.cu", [
        ("    if ((split & quad_lanes(q)) == 0) {\n      const int iy0",
         "    if (true) {\n      for (int k = 0; k < 8; ++k) pred[k] = "
         "w[k];\n    } else if ((split & quad_lanes(q)) == 0) {\n"
         "      const int iy0"),
        ("  if (sfx != 0) {", "  if (false) {")]),
    "no_satd": ("p_encode.cu", [("  if (a.mask) {\n    int s = 0;",
                                 "  if (false) {\n    int s = 0;")]),
    "no_recon": ("p_encode.cu", [
        ("      st4(a.oy + (size_t)", "      if (a.gw < 0) "
         "st4(a.oy + (size_t)"),
        ("    st4((comp ? a.ov : a.ou)", "    if (a.gw < 0) "
         "st4((comp ? a.ov : a.ou)"),
        ("  if (edge) {                    // warp-uniform",
         "  if (edge && a.gw < 0) {")]),
    # the decoder's family
    "dec_tree": ("mc_decode.cu", []),
    "residual_dec_registers_32": ("mc_decode.cu", [(RD_KERNEL, RD_KERNEL
                                  .replace("(RD_THREADS)",
                                           "(RD_THREADS, 32)"))]),
    "residual_dec_registers_40": ("mc_decode.cu", [(RD_KERNEL, RD_KERNEL
                                  .replace("(RD_THREADS)",
                                           "(RD_THREADS, 24)"))]),
    "residual_dec_blocks_128": ("mc_decode.cu", [
        ("constexpr int RD_THREADS = 64;",
         "constexpr int RD_THREADS = 128;")]),
    "residual_dec_no_stores": ("mc_decode.cu", [
        (RD_STORES, "    if (stride < 0) " + RD_STORES.lstrip())]),
    "residual_dec_no_luma_levels": ("mc_decode.cu", [
        (RD_LUMA, "a.gw > 0 || " + RD_LUMA)]),
    "params_global_tables": ("deblock.cu", [
        ("  int* tab = smem;\n", "  int* tab = smem;\n"
         "  const int* gtab = a.tab;\n"),
        (DD_TAB + "    tv =", "  if (false)\n    tv ="),
        (DD_TAB + "    reinterpret_cast<int4*>(tab)",
         "  if (false)\n    reinterpret_cast<int4*>(tab)"),
        ("hl::edge_set(tab, l,", "hl::edge_set(gtab, l,")]),
    "params_global_row_above": ("deblock.cu", [
        ("constexpr int DD_STAGED = 2 * DD_MBS + 1;",
         "constexpr int DD_STAGED = DD_MBS + 1;"),
        ("const int16_t* rt = stage + (j + 1 + DD_MBS) * a.span;",
         "const int16_t* rt = a.rec + (pic + top + mx) * a.words + a.lo;")]),
    "params_strip_16": ("deblock.cu", [(DD_MBS, DD_MBS.replace("8", "16"))]),
    "params_strip_32": ("deblock.cu", [(DD_MBS, DD_MBS.replace("8", "32"))]),
    "params_no_stores": ("deblock.cu", [("  if (live) {",
                                         "  if (live && a.gw < 0) {")]),
    "params_empty": ("deblock.cu", [
        ("k_deblock_params_dec(DdArgs a) {\n",
         "k_deblock_params_dec(DdArgs a) {\n  if (a.gw > 0) return;\n")]),
}
DEC = [n for n in VARIANTS if VARIANTS[n][0] != "p_encode.cu"]
TIMED = ("one MB", "CIF", "720p", "1080p")
DEC_SETS = (("mixed", None), ("zero-coded", 0.0), ("fully coded", 1.0))


def make(name: str) -> pathlib.Path:
    """build/variants/NAME: the package with NAME's substitutions."""
    out = REPO / "build" / "variants" / name
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(REPO / "hartallo_tpu_torch", out / "hartallo_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    source, subs = VARIANTS[name]
    cu = out / "hartallo_tpu_torch" / "csrc" / source
    text = cu.read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} is not in {source} once")
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


def built(tree: str, names) -> tuple:
    """Build TREE's kernels: (torch, chip_smoke, the result with the card
    and ptxas' lines of the kernels ``names``)."""
    sys.path.insert(0, str(REPO))
    import torch
    import chip_smoke as CS
    sys.path.insert(0, str(pathlib.Path(tree).resolve()))
    from hartallo_tpu_torch import kernels
    if not torch.cuda.is_available():
        raise SystemExit("port_residual_variants: torch sees no CUDA device")
    kernels.build()
    res = {"card": CS.card_line(), "variant": pathlib.Path(tree).name}
    log = kernels.BUILD_LOG.splitlines()
    for i, line in enumerate(log):
        for kname in names:
            if kname in line and "Compiling entry" in line:
                res[f"ptxas {kname}"] = " | ".join(
                    s.strip() for s in log[i + 1:i + 4])
    return torch, CS, res


def time_tree(tree: str, with_clock: bool) -> None:
    torch, CS, res = built(tree, ("k_p_residual",))
    from hartallo_tpu_torch.encode import p_body_fast as PB
    res["kernel_us"] = {}
    if with_clock:
        res["clock"] = clock(torch)
    for k, (label, *_) in enumerate(CS.P_CASES):
        if label in TIMED:
            _, _, args, kw = path_inputs(torch, k)
            res["kernel_us"][label] = CS.kernel_us(
                torch, lambda: PB.p_residual_fast(*args, **kw), 20,
                "k_p_residual")
    print(json.dumps(res), flush=True)


def time_dec_tree(tree: str) -> None:
    torch, CS, res = built(tree, ("k_residual_dec", "k_deblock_params_dec"))
    from hartallo_tpu_torch.decode import mc_decode_fast as M
    from hartallo_tpu_torch.ops import deblock_fast as D
    res.update(residual_us={}, params_us={})
    for k, (label, gw, gh, _) in enumerate(CS.MC_DEC_CASES):
        if label not in CS.MC_DEC_TIMED:
            continue
        for tag, coded in DEC_SETS:
            rec, offs = CS.residual_rec_inputs(gw, gh, 1, CS.SEED + k,
                                               coded=coded)
            trec = torch.tensor(rec, device="cuda")
            res["residual_us"][f"{tag} {label}"] = CS.kernel_us(
                torch, lambda: M.residual_planes_fast(trec, offs, 0, gw=gw,
                                                      gh=gh),
                20, "k_residual_dec")
        rec, offs = CS.deblock_rec_inputs(gw, gh, 1, CS.SEED + k, wide=True)
        trec = torch.tensor(rec, device="cuda")
        res["params_us"][label] = CS.kernel_us(
            torch, lambda: D.deblock_params_dec_fast(trec, offs, 0, gw=gw,
                                                     gh=gh),
            20, "k_deblock_params_dec")
    print(json.dumps(res), flush=True)


def main(argv) -> None:
    if argv[:1] == ["--time"]:
        if pathlib.Path(argv[1]).name in DEC:
            time_dec_tree(argv[1])
        else:
            time_tree(argv[1], "--clock" in argv)
        return
    family = DEC if "--dec" in argv else \
        [n for n in VARIANTS if n not in DEC]
    names = [a for a in argv if not a.startswith("--")] or \
        [*family, family[0]]
    for i, name in enumerate(names):
        cmd = [sys.executable, __file__, "--time", str(make(name))]
        if "--clock" in argv and i == 0:
            cmd.append("--clock")
        subprocess.run(cmd, check=True)


if __name__ == "__main__":
    main(sys.argv[1:])
