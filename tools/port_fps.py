"""End-to-end decode and encode rates of the port on a CUDA device, for
comparing two trees on one card in one run.

    python tools/port_fps.py [--tree DIR] [--runs N] [--decode]

Imports ``hartallo_tpu_torch`` from ``DIR`` (this tree by default: give a
checkout of another commit to time it on the same fixtures) and prints
one JSON line with the card's name and power limit and, through
``chip_smoke.py``'s ``decode_rates`` and ``encode_rates``:

- decode fps of ``cif_16``, ``720p_8`` and ``1080p_8`` through
  ``Codec.decode_annexb``: one warm-up decode, then ``N`` timed ones
  (default 3), every frame's MD5 checked;
- encode fps of ``cif_16`` and ``720p_8`` through
  ``Codec.encode_frames`` with ``bench.py``'s settings: a warm-up encode
  of each clip's first two frames, then ``N`` timed encodes of the
  whole clip, each stream equal to the fixture; and of ``svc3_4cif_8``
  through ``Codec.encode`` (``chip_smoke.svc_encode``), in access units
  per second, after one warm-up encode, each stream equal to the fixture
  (all three left out with ``--decode``).

Run it for each tree in turns in one command (parent, this tree, this
tree, parent) to compare them.  ``python tools/port_fps.py --pairs
FILE`` reads such runs' JSON lines, two lines a pair, the tree of the
first line the baseline, and prints for each fixture the median and
quartiles over the pairs of each tree's median rate, and how many
pairs the other tree won.
"""
from __future__ import annotations

import json
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
DECODES = ("cif_16", "720p_8", "1080p_8")
ENCODES = ("cif_16", "720p_8")
SVC = "svc3_4cif_8"


def main(argv) -> None:
    tree = argv[argv.index("--tree") + 1] if "--tree" in argv else str(REPO)
    runs = int(argv[argv.index("--runs") + 1]) if "--runs" in argv else 3
    sys.path.insert(0, str(REPO))
    import torch

    # this tree's chip_smoke, then the package of the tree under test
    from bench import make_clip
    from chip_smoke import (card_line, decode_rates, encode_rates,
                            load_fixture, svc_clips, svc_encode)
    sys.path.insert(0, str(pathlib.Path(tree).resolve()))
    from hartallo_tpu_torch import kernels
    from hartallo_tpu_torch.api import Codec, CodecConfig

    if not torch.cuda.is_available():
        raise SystemExit("port_fps: torch sees no CUDA device")
    kernels.build()
    res = {"card": card_line(), "tree": str(pathlib.Path(tree).resolve()),
           "decode_fps": {name: decode_rates(torch, name, runs)
                          for name in DECODES}, "encode_fps": {}}
    for name in () if "--decode" in argv else ENCODES:
        meta = load_fixture(name)[1]
        W, H = meta["width"], meta["height"]
        Codec(CodecConfig(width=W, height=H, qp=30, gop_size=2,
                          deblock=True, me_range=12)).encode_frames(
            make_clip(W, H, 2), W, H)                         # warm-up
        res["encode_fps"][name] = encode_rates(torch, name, runs)
    if "--decode" not in argv:
        want, meta = load_fixture(SVC)
        clips = svc_clips(meta)
        svc_encode(torch, meta, clips)                        # warm-up
        res["encode_fps"][SVC] = []
        for _ in range(runs):
            stream, dt = svc_encode(torch, meta, clips)
            if stream != want:
                raise SystemExit(f"{SVC}: the encode differs from the "
                                 "fixture")
            res["encode_fps"][SVC].append(meta["frames"] / dt)
    print(json.dumps(res), flush=True)


def pairs(path: str) -> None:
    """Summarise alternating pairs of runs (see the module docstring)."""
    import numpy as np
    rows = [json.loads(line) for line in open(path) if line.strip()]
    base = rows[0]["tree"]
    for kind in ("decode_fps", "encode_fps"):
        for name in rows[0][kind]:
            per = {True: [], False: []}             # is baseline -> medians
            wins = 0
            for a, b in zip(rows[::2], rows[1::2]):
                med = {r["tree"] == base: float(np.median(r[kind][name]))
                       for r in (a, b)}
                wins += med[False] > med[True]
                for k, v in med.items():
                    per[k].append(v)
            q = {k: np.percentile(v, [25, 50, 75]) for k, v in per.items()}
            print(f"{kind} {name}: baseline {q[True][1]:.2f} "
                  f"[{q[True][0]:.2f}, {q[True][2]:.2f}], other "
                  f"{q[False][1]:.2f} [{q[False][0]:.2f}, "
                  f"{q[False][2]:.2f}] (median [quartiles] of "
                  f"{len(per[True])} pairs); other won {wins}")


if __name__ == "__main__":
    if "--pairs" in sys.argv:
        pairs(sys.argv[sys.argv.index("--pairs") + 1])
    else:
        main(sys.argv[1:])
