"""Times of the port's two CUDA kernels, for comparing two trees on one
card in one run.

    python tools/port_kernel_times.py dump PAYLOADS.npz
    python tools/port_kernel_times.py time PAYLOADS.npz [--tree DIR] [--plain]

``dump`` parses the fixtures with this tree's decoder (nothing is
decoded) and stores the GOP kernel's payloads: the 16 pictures of
``cif_16``, and the IDR picture and the six or seven P pictures of
``720p_8`` and ``1080p_8``.  ``time`` imports ``hartallo_tpu_torch`` from
``DIR`` (this tree by default: give a checkout of another commit to time
its kernels on the same payloads, whose layout has not changed) and, on
a CUDA device, prints one JSON line with the card's name and power
limit:

- the GOP kernel (``decode_gop_fast``, all stages) in µs per picture
  over each payload, CUDA events around repeated calls after a warm-up;
- the frame deblock at the CIF, 720p and 1080p MB grids and the 720p grid
  with slice-edge flags (``chip_smoke.deblock_inputs``): the launch
  alone and the wrapper with its parameter gather, µs per frame;
- the intra encode kernel (``intra_encode_frame_fast``) on the first
  ``bench.make_clip`` frame at CIF, 720p and 1080p
  (``chip_smoke.intra_inputs``), µs per picture, where the tree has it;
- with ``--plain``, the plain twins once each (the CIF batch, the 720p
  IDR picture, every deblock grid, the intra encode at CIF and 720p);
- each kernel's bound (``chip_smoke.gop_bound`` / ``deblock_bound`` /
  ``intra_bound``).
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PICTURES = {"cif_16": ("cif16", None), "720p_8": ("720p", 0),
            "1080p_8": ("1080p", 0)}


def dump(path: str) -> None:
    import numpy as np

    sys.path.insert(0, str(REPO))
    from chip_smoke import load_fixture
    from hartallo_tpu_torch.decode.d_gop_fast import stack_payload
    from hartallo_tpu_torch.decode.decoder import Decoder
    arrays = {}
    for name, (tag, idr) in PICTURES.items():
        dec = Decoder(device="cpu", batch_k=1 << 30)
        dec.enqueue_annexb(load_fixture(name)[0], tolerant=False)
        jobs = dec.layer.jobs
        gw, gh, S, _ = dec.layer.ring_key
        groups = {tag: jobs} if idr is None else {
            f"{tag}_idr": jobs[:1], f"{tag}_p": jobs[1:]}
        for key, run in groups.items():
            pay = stack_payload([j.fast for j in run])
            for k, v in pay.items():
                arrays[f"{key}/{k}"] = v
            arrays[f"{key}/geo"] = np.array([gw, gh, S], np.int32)
    np.savez(path, **arrays)
    print(f"wrote {sorted({k.split('/')[0] for k in arrays})} to {path}")


def _payloads(path: str):
    import numpy as np
    z = np.load(path)
    out = {}
    for key in sorted({k.split("/")[0] for k in z.files}):
        gw, gh, S = (int(v) for v in z[f"{key}/geo"])
        out[key] = ({k.split("/")[1]: z[k] for k in z.files
                     if k.startswith(key + "/") and not k.endswith("/geo")},
                    gw, gh, S)
    return out


def time_kernels(path: str, tree: str, plain: bool) -> None:
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    # this tree's chip_smoke, then the package of the tree under test
    from chip_smoke import (SEED, DEBLOCK_GRIDS, INTRA_CASES, INTRA_TIMED,
                            card_line, deblock_bound, deblock_inputs,
                            event_ms, gop_bound, intra_bound, intra_inputs)
    sys.path.insert(0, str(pathlib.Path(tree).resolve()))
    from hartallo_tpu_torch import kernels
    from hartallo_tpu_torch.decode import d_gop_fast as F
    from hartallo_tpu_torch.decode.d_gop import ring_shapes
    from hartallo_tpu_torch.ops import deblock_fast as D
    from hartallo_tpu_torch.ops.deblock import edge_params

    if not torch.cuda.is_available():
        raise SystemExit("port_kernel_times: torch sees no CUDA device")
    kernels.build()
    res = {"card": card_line(), "tree": str(pathlib.Path(tree).resolve()),
           "gop_us_per_picture": {}, "gop_plain_us_per_picture": {},
           "gop_bound_us_per_picture": {}, "deblock_launch_us": {},
           "deblock_wrapper_us": {}, "deblock_plain_us": {},
           "deblock_bound_us": {}, "intra_us": {}, "intra_plain_us": {},
           "intra_bound_us": {}}
    for key, (pay, gw, gh, S) in _payloads(path).items():
        K = pay["sf"].shape[0]
        rng = np.random.default_rng(SEED)
        rings = F.rings_from_numpy(*(rng.integers(0, 256, s, dtype=np.uint8)
                                     for s in ring_shapes(gw, gh, S)),
                                   "cuda")
        p = F.payload_to(pay, "cuda")
        args = [p[k] for k in ("smb", "aux", "sf", "tags", "vals", "ilist",
                               "ivals")]
        reps = 10 if gw * gh < 1000 else 3
        res["gop_us_per_picture"][key] = 1e3 * event_ms(
            torch, lambda: F.decode_gop_fast(*args, *rings, gw=gw, gh=gh),
            reps) / K
        res["gop_bound_us_per_picture"][key] = 1e3 * gop_bound(pay, gw,
                                                               gh)[0]
        if plain and key in ("cif16", "720p_idr"):
            res["gop_plain_us_per_picture"][key] = 1e3 * event_ms(
                torch, lambda: F.decode_gop_fast_plain(*args, *rings, gw=gw,
                                                       gh=gh), 1) / K
    for name, gw, gh, flags in DEBLOCK_GRIDS:
        planes, rest = deblock_inputs(gw, gh, SEED + gw, flags)
        tp = tuple(torch.tensor(x, device="cuda") for x in planes)
        ta = tuple(torch.tensor(a, device="cuda") for a in rest)
        aux = edge_params(*ta).to(torch.int16).contiguous()
        res["deblock_launch_us"][name] = 1e3 * event_ms(
            torch, lambda: D._launch(aux, tp, gw=gw, gh=gh), 20)
        res["deblock_wrapper_us"][name] = 1e3 * event_ms(
            torch, lambda: D.deblock_frame_fast(tp, *ta, gw=gw, gh=gh), 20)
        res["deblock_bound_us"][name] = 1e3 * deblock_bound(planes,
                                                            rest)[0]
        if plain:
            res["deblock_plain_us"][name] = 1e3 * event_ms(
                torch, lambda: D.deblock_frame_fast_plain(tp, *ta, gw=gw,
                                                          gh=gh), 1)
    if importlib.util.find_spec(
            "hartallo_tpu_torch.encode.intra_encode_fast") is not None:
        from hartallo_tpu_torch.encode import intra_encode_fast as IF
        for k, (name, W, H, opts) in enumerate(INTRA_CASES):
            if name not in INTRA_TIMED:
                continue
            gw, gh, args, kw = intra_inputs(W, H, SEED + k, **opts)
            ta = [torch.tensor(a, device="cuda") if isinstance(a, np.ndarray)
                  else a for a in args]
            res["intra_us"][name] = 1e3 * event_ms(
                torch, lambda: IF.intra_encode_frame_fast(*ta, gw=gw, gh=gh),
                10)
            res["intra_bound_us"][name] = 1e3 * intra_bound(gw, gh,
                                                            False)[0]
            if plain and name != "1080p":
                res["intra_plain_us"][name] = 1e3 * event_ms(
                    torch, lambda: IF.intra_encode_frame(*ta, gw=gw, gh=gh),
                    1)
    print(json.dumps(res), flush=True)


def main(argv) -> None:
    if len(argv) >= 2 and argv[0] == "dump":
        dump(argv[1])
    elif len(argv) >= 2 and argv[0] == "time":
        tree = argv[argv.index("--tree") + 1] if "--tree" in argv else \
            str(REPO)
        time_kernels(argv[1], tree, "--plain" in argv)
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main(sys.argv[1:])
