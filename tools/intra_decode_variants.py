"""Other forms of the decoder's intra wavefront kernel
(``csrc/intra_decode.cu``), for timing against this tree's on one card.

    python tools/intra_decode_variants.py write [DIR]
    python tools/intra_decode_variants.py check TREE

``write`` makes DIR/<name>/hartallo_tpu_torch (DIR defaults to
build/variants), a copy of this tree's package whose kernel is replaced:

- ``cluster2``, ``cluster4``, ``cluster8``: ``tools/variants/
  intra_decode_cluster.cu`` with CLUSTER rows a thread-block cluster: in
  a cluster a row writes the bottom rows of its intra MBs into the shared
  memory of the row below and raises that row's counter there (a
  cluster-scope release), so the row below polls and reads its own
  shared memory instead of L2; the launch is cooperative with a cluster
  dimension, the grid rounded up to whole clusters;
- ``<name>_one_block_an_sm`` for each of those and ``tree``: 120 KB of
  dynamic shared memory a block, so that no two rows share an SM
  (``tree_one_block_an_sm`` is this tree's kernel so);
- ``slots3``: this tree's kernel with three shared slots instead of two.

``check`` holds TREE's kernel against its plain twin on
``chip_smoke.INTRA_DEC_CASES`` but the all-intra 1080p picture (the
twin's slowest), on the card; it exits 1 if any output differs.  Time a
variant with ``python tools/port_kernel_times.py time none --dec-only
--tree DIR/<name>``, in turns with this tree, in one command.
"""
from __future__ import annotations

import pathlib
import re
import shutil
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = REPO / "hartallo_tpu_torch"
CLUSTER_SOURCE = REPO / "tools" / "variants" / "intra_decode_cluster.cu"
SMEM = 120 * 1024


def _one_block_an_sm(text: str) -> str:
    """The kernel source with every launch given at least SMEM bytes of
    dynamic shared memory."""
    if "const int smem = smem_bytes(gw);" in text:
        text = text.replace("const int smem = smem_bytes(gw);",
                            f"const int smem = max(smem_bytes(gw), {SMEM});")
    else:
        text = text.replace(
            "  void* args[] = {&a};",
            "  void* args[] = {&a};\n"
            f"  const int smem = max(smem_bytes(gw), {SMEM});\n"
            "  const cudaError_t e = cudaFuncSetAttribute(k_intra_decode,\n"
            "      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);\n"
            "  if (e != cudaSuccess) return (int)e;")
        text = text.replace("args,\n                                          "
                            "smem_bytes(gw), stream);",
                            "args,\n                                          "
                            "smem, stream);")
    if str(SMEM) not in text or "smem_bytes(gw), stream" in text:
        raise SystemExit("intra_decode_variants: the launch has changed")
    return text


def write(out: pathlib.Path) -> None:
    tree = (PACKAGE / "csrc" / "intra_decode.cu").read_text()
    cluster = CLUSTER_SOURCE.read_text()
    if "constexpr int NSLOT = 2;" not in tree:
        raise SystemExit("intra_decode_variants: NSLOT has changed")
    sources = {"tree_one_block_an_sm": _one_block_an_sm(tree),
               "slots3": tree.replace("constexpr int NSLOT = 2;",
                                      "constexpr int NSLOT = 3;")}
    for size in (2, 4, 8):
        text = re.sub(r"constexpr int CLUSTER = \d+;",
                      f"constexpr int CLUSTER = {size};", cluster)
        sources[f"cluster{size}"] = text
        sources[f"cluster{size}_one_block_an_sm"] = _one_block_an_sm(text)
    for name, text in sources.items():
        dst = out / name / "hartallo_tpu_torch"
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(PACKAGE, dst,
                        ignore=shutil.ignore_patterns("__pycache__"))
        (dst / "csrc" / "intra_decode.cu").write_text(text)
        print(dst)


def check(tree: str) -> int:
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(pathlib.Path(tree).resolve()))
    import torch

    from chip_smoke import INTRA_DEC_CASES, SEED, intra_dec_inputs
    from hartallo_tpu_torch.decode import intra_recon_fast as F
    from hartallo_tpu_torch.decode.intra_recon import intra_reconstruct
    if not torch.cuda.is_available():
        raise SystemExit("intra_decode_variants: torch sees no CUDA device")
    bad = 0
    for label, gw, gh, opts in INTRA_DEC_CASES:
        if label == "1080p":
            continue
        args = [None if a is None else torch.tensor(a, device="cuda")
                for a in intra_dec_inputs(gw, gh, SEED, **opts)]
        got = F.intra_reconstruct_fast(tuple(args[:3]), *args[3:], gw=gw,
                                       gh=gh)
        want = intra_reconstruct(tuple(args[:3]), *args[3:], gw=gw, gh=gh)
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        bad += not same
        print(f"{tree} {label}: == plain {same}", flush=True)
    return 1 if bad else 0


def main(argv) -> int:
    if argv[:1] == ["write"]:
        write(pathlib.Path(argv[1]) if len(argv) > 1 else
              REPO / "build" / "variants")
        return 0
    if argv[:1] == ["check"] and len(argv) == 2:
        return check(argv[1])
    raise SystemExit(__doc__)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
