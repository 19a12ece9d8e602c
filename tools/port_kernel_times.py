"""Times of the port's CUDA kernels, for comparing two trees on one card
in one run.

    python tools/port_kernel_times.py dump PAYLOADS.npz
    python tools/port_kernel_times.py time PAYLOADS.npz [--tree DIR] [--plain]
        [--intra-only | --me-only | --p-only]

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
  ``bench.make_clip`` frame of one MB, CIF, 720p and 1080p
  (``chip_smoke.intra_inputs``), µs per picture with the wrapper (CUDA
  events) and of the kernel alone (``chip_smoke.kernel_us``, the
  profiler's device time), where the tree has it, and its chain floor at
  each size: the gw + 2 gh - 2 MBs of the wavefront's critical path
  times the one-MB picture's kernel time (its launch included);
- the motion search kernels on the ``bench.make_clip`` frame pair at
  CIF, 720p and 1080p (``chip_smoke.me_inputs``), where the tree has
  them: the full search (``full_search_int_fast``) and a P picture's
  refinement, the half-pel round and then the quarter-pel round on its
  MVs (one ``refine_subpel_rounds_fast`` call, or on a tree without it
  two ``refine_subpel_fast`` calls), on the MVs and partition map the
  path derives from the search (``chip_smoke.me_path_maps``) and, as
  ``refine_seeded``, on seeded MVs of every 4x4 block; each in µs per
  picture with the
  wrapper (CUDA events), alone (``chip_smoke.kernel_us``, every launch
  of the call) and the wrapper's host time per call
  (``chip_smoke.host_us``, no sync);
- with ``--plain``, the plain twins once each (the CIF batch, the 720p
  IDR picture, every deblock grid, the intra encode at one MB, CIF and
  720p, the
  motion search at CIF, 720p and 1080p);
- each kernel's bound (``chip_smoke.gop_bound`` / ``deblock_bound`` /
  ``intra_bound`` / ``me_bound``).

- the P-picture body on ``chip_smoke.p_inputs`` at CIF, 720p and 1080p
  (P_TIMED): one ``p_device.p_frame_device`` call (the search, the
  partition decision, the refinement and the residual of one P picture)
  and one ``e_device.deblock_recon_device`` call on its outputs, µs per
  picture (CUDA events), on any tree; and where the tree has
  ``encode/p_body_fast``, each of its four kernels on the path's inputs
  (``chip_smoke.p_check``): µs per picture with the wrapper, alone and
  the wrapper's host time, the plain twin's with ``--plain``, and its
  bound (``chip_smoke.p_bound``).

``--intra-only`` times the intra encode kernel alone, ``--me-only`` the
motion search kernels alone and ``--p-only`` the P-picture body alone
(for turns of two trees on one card: parent, tree, tree, parent); the
payloads are then not read.
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


def time_p_body(res: dict, plain: bool) -> None:
    """The P-picture body's entries of ``res`` (see the top)."""
    import torch

    from chip_smoke import (P_CASES, P_KERNELS, P_TIMED, event_ms, host_us,
                            kernel_us, p_bound, p_case_tensors, p_check)
    from hartallo_tpu_torch.encode import e_device as E
    from hartallo_tpu_torch.encode import p_device as PD
    fast = importlib.util.find_spec(
        "hartallo_tpu_torch.encode.p_body_fast") is not None
    for key in ("p_frame_us", "deblock_recon_us"):
        res[key] = {}
    for n in P_KERNELS if fast else ():
        for k in ("us", "kernel_us", "host_us", "plain_us", "bound_us"):
            res.setdefault(f"{n}_{k}", {})
    for k, (label, _, _, _) in enumerate(P_CASES):
        if label not in P_TIMED:
            continue
        _, gw, gh, t = p_case_tensors(torch, k)
        args = (*t["src"], *t["ref"], t["qp"], t["lam"])
        kw = dict(gw=gw, gh=gh, rng=t["rng"], refine=True,
                  chroma_qp_off=t["cqo"])
        out = PD.p_frame_device(*args, **kw)
        wq, mv44, planes = out[0], out[3], out[5:8]
        ref44 = torch.zeros((gh, gw, 4, 4), dtype=torch.int32, device="cuda")
        res["p_frame_us"][label] = 1e3 * event_ms(
            torch, lambda: PD.p_frame_device(*args, **kw), 5)
        res["deblock_recon_us"][label] = 1e3 * event_ms(
            torch, lambda: E.deblock_recon_device(
                wq, mv44, ref44, t["intra"], t["qp"], t["cqo"], planes, gw,
                gh), 5)
        if not fast:
            continue
        for n, (_, same, ms, fn) in p_check(torch, label, gw, gh,
                                            t).items():
            if not same:
                raise SystemExit(f"{n} != its twin at {label}")
            res[f"{n}_us"][label] = 1e3 * event_ms(torch, fn, 10)
            res[f"{n}_kernel_us"][label] = kernel_us(torch, fn, 10,
                                                     P_KERNELS[n])
            res[f"{n}_host_us"][label] = host_us(fn, 10)
            res[f"{n}_bound_us"][label] = 1e3 * p_bound(n, gw, gh)[0]
            if plain:
                res[f"{n}_plain_us"][label] = 1e3 * ms


def time_kernels(path: str, tree: str, plain: bool,
                 intra_only: bool = False, me_only: bool = False,
                 p_only: bool = False) -> None:
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    # this tree's chip_smoke, then the package of the tree under test
    from chip_smoke import (SEED, DEBLOCK_GRIDS, INTRA_CASES, INTRA_TIMED,
                            ME_CASES, ME_TIMED, card_line, deblock_bound,
                            deblock_inputs, event_ms, gop_bound, host_us,
                            intra_bound, intra_inputs, kernel_us, me_bound,
                            me_inputs, me_path_maps, sm_clock_hz)
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
           "intra_kernel_us": {}, "intra_bound_us": {},
           "intra_chain_floor_us": {},
           "full_search_us": {}, "full_search_kernel_us": {},
           "full_search_host_us": {}, "full_search_plain_us": {},
           "full_search_bound_us": {}, "refine_us": {},
           "refine_kernel_us": {}, "refine_host_us": {},
           "refine_plain_us": {}, "refine_bound_us": {},
           "refine_seeded_us": {}, "refine_seeded_kernel_us": {},
           "refine_seeded_host_us": {}}
    alone = intra_only or me_only or p_only
    for key, (pay, gw, gh, S) in ({} if alone else
                                  _payloads(path)).items():
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
    for name, gw, gh, flags in () if alone else DEBLOCK_GRIDS:
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
    if not (me_only or p_only) and importlib.util.find_spec(
            "hartallo_tpu_torch.encode.intra_encode_fast") is not None:
        from hartallo_tpu_torch.encode import intra_encode_fast as IF
        grids = {}
        for k, (name, W, H, opts) in enumerate(INTRA_CASES):
            if name not in INTRA_TIMED:
                continue
            gw, gh, args, kw = intra_inputs(W, H, SEED + k, **opts)
            ta = [torch.tensor(a, device="cuda") if isinstance(a, np.ndarray)
                  else a for a in args]
            def call():
                IF.intra_encode_frame_fast(*ta, gw=gw, gh=gh)
            res["intra_us"][name] = 1e3 * event_ms(torch, call, 10)
            res["intra_kernel_us"][name] = kernel_us(torch, call, 10,
                                                     "intra_encode")
            res["intra_bound_us"][name] = 1e3 * intra_bound(gw, gh,
                                                            False)[0]
            if plain and name != "1080p":
                res["intra_plain_us"][name] = 1e3 * event_ms(
                    torch, lambda: IF.intra_encode_frame(*ta, gw=gw, gh=gh),
                    1)
            grids[name] = (gw, gh)
        mb_us = res["intra_kernel_us"]["one MB"]
        for name, (gw, gh) in grids.items():
            res["intra_chain_floor_us"][name] = None if mb_us is None \
                else (gw + 2 * gh - 2) * mb_us
    if not (intra_only or p_only) and importlib.util.find_spec(
            "hartallo_tpu_torch.encode.me_fast") is not None:
        from hartallo_tpu_torch.encode import me as M
        from hartallo_tpu_torch.encode import me_fast as MF
        from hartallo_tpu_torch.ops.wide import halfpel_planes
        clock = sm_clock_hz()
        res["sm_clock_hz"] = clock
        rounds = getattr(MF, "refine_subpel_rounds_fast", None)
        res["refine_calls_per_picture"] = 1 if rounds else 2
        for k, (name, W, H, opts) in enumerate(ME_CASES):
            if name not in ME_TIMED:
                continue
            gw, gh, c = me_inputs(W, H, SEED + k, **opts)
            src, ref, seeded_mv, seeded_part = (
                torch.tensor(c[n], device="cuda")
                for n in ("src", "ref", "mv", "part"))
            lam, rng = torch.tensor(c["lam"], device="cuda"), c["rng"]
            hp = halfpel_planes(ref)
            # the MVs and partitions the path derives from the search
            path_mv, path_part = (
                torch.tensor(a, device="cuda") for a in me_path_maps(
                    [t.cpu().numpy() for t in M.full_search_int(
                        src, ref, lam, gw=gw, gh=gh, rng=rng)], c["lam"]))
            mv, part = path_mv, path_part

            def full_search():
                MF.full_search_int_fast(src, ref, lam, gw=gw, gh=gh,
                                        rng=rng)

            def refine():
                if rounds:
                    rounds(src, ref, mv, part, lam, (2, 1), gw=gw, gh=gh,
                           nparts=4, hp=hp)
                    return
                half = MF.refine_subpel_fast(src, ref, mv, part, lam, 2,
                                             gw=gw, gh=gh, nparts=4, hp=hp)
                MF.refine_subpel_fast(src, ref, half[0], part, lam, 1,
                                      gw=gw, gh=gh, nparts=4, hp=hp)

            def twin_chain():
                half = M.refine_subpel(src, ref, mv, part, lam, 2, gw=gw,
                                       gh=gh, nparts=4, hp=hp)
                M.refine_subpel(src, ref, half[0], part, lam, 1, gw=gw,
                                gh=gh, nparts=4, hp=hp)
            calls = {"full_search": (full_search, "k_full_search",
                                     lambda: M.full_search_int(
                                         src, ref, lam, gw=gw, gh=gh,
                                         rng=rng)),
                     "refine": (refine, "k_refine", twin_chain)}
            for key, (fn, kname, twin) in calls.items():
                launches = 1 if key == "full_search" or rounds else 2
                res[f"{key}_us"][name] = 1e3 * event_ms(torch, fn, 10)
                res[f"{key}_kernel_us"][name] = kernel_us(
                    torch, fn, 10, kname, launches)
                res[f"{key}_host_us"][name] = host_us(fn, 10)
                res[f"{key}_bound_us"][name] = 1e3 * me_bound(
                    gw, gh, rng, key, clock)[0]
                if plain:
                    res[f"{key}_plain_us"][name] = 1e3 * event_ms(
                        torch, twin, 1)
            mv, part = seeded_mv, seeded_part
            res["refine_seeded_us"][name] = 1e3 * event_ms(torch, refine, 10)
            res["refine_seeded_kernel_us"][name] = kernel_us(
                torch, refine, 10, "k_refine", 1 if rounds else 2)
            res["refine_seeded_host_us"][name] = host_us(refine, 10)
    if not (intra_only or me_only):
        time_p_body(res, plain)
    print(json.dumps(res), flush=True)


def main(argv) -> None:
    if len(argv) >= 2 and argv[0] == "dump":
        dump(argv[1])
    elif len(argv) >= 2 and argv[0] == "time":
        tree = argv[argv.index("--tree") + 1] if "--tree" in argv else \
            str(REPO)
        time_kernels(argv[1], tree, "--plain" in argv,
                     "--intra-only" in argv, "--me-only" in argv,
                     "--p-only" in argv)
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main(sys.argv[1:])
