"""Times of the port's CUDA kernels, for comparing two trees on one card
in one run.

    python tools/port_kernel_times.py dump PAYLOADS.npz
    python tools/port_kernel_times.py time PAYLOADS.npz [--tree DIR] [--plain]
        [--intra-only | --me-only | --p-only | --dec-only | --scan-only]

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
  bound (``chip_smoke.p_bound``); and the launch floor, the profiler's
  device time of a one-element fill (``chip_smoke.launch_floor_us``).

- the decoder's intra wavefront (``intra_reconstruct_fast``), where the
  tree has it, on ``chip_smoke.intra_dec_inputs`` at the chain model's
  unit pictures (``chip_smoke.DEC_UNITS``: one MB, 120x1, 1x68) and
  ``chip_smoke.DEC_TIMED`` (CIF, 720p, 1080p, the 120x34 band, all
  intra, and 1080p with one intra MB in 50): µs per picture with the
  wrapper (CUDA events) and alone (``chip_smoke.kernel_us``), the plain
  twin's with ``--plain``, its bound (``chip_smoke.intra_dec_bound``,
  on the picture's intra MBs), the in-row step s and hand-off h from
  the unit pictures less the launch floor, and the chain model
  (``chip_smoke.intra_dec_model``) at the all-intra sizes.

- the GOP scan's residual, MC and ring write kernels
  (``decode/mc_decode_fast``), where the tree has them, each checked
  against its twin and timed by ``chip_smoke.scan_kernels``, on three
  input sets: ``seeded``, ``chip_smoke.residual_rec_inputs`` (one
  picture), ``mc_dec_inputs`` (three slots; MVs up to 2,000 quarter pels
  out for a third of the blocks, so that most of those clamp to the
  edge) and ``ring_write_inputs`` at ``chip_smoke.MC_DEC_TIMED`` (CIF,
  720p, 1080p and the 120x34 band with its int32 stacks); ``fixture``,
  the first GOP scan batch of ``1080p_8_wp`` (the stream decoded on the
  card up to that batch), its first picture's record, residual, MVs,
  slots, weights and inter map as ``d_gop.prepare_pictures`` builds
  them, over seeded reference rings (at the band: its top 34 MB rows
  over seeded int32 stacks; the ring write on the MC's output): one MV
  and one slot an 8x8 quadrant, the motion of ``1080p_8`` with a weight
  table added; and ``fixture_4x4``, the same with each 4x4 block's MV
  moved by a seeded offset in -16..16 quarter pels and each quadrant's
  slot redrawn over two references of a three-slot ring, the motion of
  sub-8x8 partitions and several references.  Each kernel in µs per
  picture with the wrapper (CUDA events), alone
  (``chip_smoke.kernel_us``), the wrapper's host time
  (``chip_smoke.host_us``), the plain twin's on the run that checks the
  kernel against it (tolerance 0), and its bound
  (``chip_smoke.residual_dec_bound`` / ``mc_dec_bound`` /
  ``ring_write_bound``).  Besides, at each seeded size, the residual
  alone on a zero-coded, a sparse (15%) and a fully coded record
  (``residual_rec_inputs(coded=)``), and the decoder's deblock parameter
  kernel (``deblock_params_dec_fast``) on the scan's dense buffer
  (``deblock_rec_inputs(wide=True)``) and on the fixture's first
  picture, each checked against its twin and timed the same way (bound
  ``chip_smoke.params_dec_bound``).  The records are int16; a tree whose
  wrappers take them as int32 (older than the int16 upload) is fed them
  widened, with the same bounds.

``--intra-only`` times the intra encode kernel alone, ``--me-only`` the
motion search kernels alone, ``--p-only`` the P-picture body alone,
``--dec-only`` the decoder's intra wavefront alone and ``--scan-only``
the GOP scan's kernels alone (for turns of two trees on one card:
parent, tree, tree, parent); the payloads are then not read.
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
                            kernel_us, launch_floor_us, p_bound,
                            p_case_tensors, p_check)
    from hartallo_tpu_torch.encode import e_device as E
    from hartallo_tpu_torch.encode import p_device as PD
    fast = importlib.util.find_spec(
        "hartallo_tpu_torch.encode.p_body_fast") is not None
    res["launch_floor_us"] = launch_floor_us(torch)
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


def time_intra_dec(res: dict, plain: bool) -> None:
    """The decoder's intra wavefront's entries of ``res`` (see the top)."""
    import numpy as np
    import torch

    from chip_smoke import (DEC_TIMED, DEC_UNITS, INTRA_DEC_CASES, SEED,
                            event_ms, intra_dec_bound, intra_dec_inputs,
                            intra_dec_model, kernel_us, launch_floor_us)
    from hartallo_tpu_torch.decode import intra_recon_fast as IDF
    from hartallo_tpu_torch.decode.intra_recon import intra_reconstruct
    floor = res["launch_floor_us"] = launch_floor_us(torch)
    out = {k: res.setdefault(f"intra_dec_{k}", {}) for k in
           ("us", "kernel_us", "plain_us", "bound_us", "model_us")}
    full = set()
    for label, gw, gh, opts in (*((*u, {}) for u in DEC_UNITS),
                                *(c for c in INTRA_DEC_CASES
                                  if c[0] in DEC_TIMED)):
        inputs = intra_dec_inputs(gw, gh, SEED, **opts)
        n = int(np.isin(inputs[5], (0, 1)).sum())
        if n == gw * gh:
            full.add((label, gw, gh))
        args = [None if a is None else torch.tensor(a, device="cuda")
                for a in inputs]

        def call():
            IDF.intra_reconstruct_fast(tuple(args[:3]), *args[3:], gw=gw,
                                       gh=gh)
        out["us"][label] = 1e3 * event_ms(torch, call, 10)
        out["kernel_us"][label] = kernel_us(torch, call, 10,
                                            "k_intra_decode")
        out["bound_us"][label] = 1e3 * intra_dec_bound(gw, gh, n)[0]
        if plain:
            out["plain_us"][label] = 1e3 * event_ms(
                torch, lambda: intra_reconstruct(tuple(args[:3]), *args[3:],
                                                 gw=gw, gh=gh), 1)
    t = out["kernel_us"]
    if None in (floor, t["120x1"], t["1x68"]):
        return
    s_us = res["intra_dec_s_us"] = (t["120x1"] - floor) / 120
    h_us = res["intra_dec_h_us"] = (t["1x68"] - floor) / 68 - s_us
    for label, gw, gh in full:
        if label in DEC_TIMED:
            out["model_us"][label] = intra_dec_model(gw, gh, s_us, h_us)


SCAN_FIXTURE = "1080p_8_wp"
# the --X-only modes: time only that part (see the top)
ONLY = ("intra", "me", "p", "dec", "scan")


def _scan_batch(torch):
    """The first GOP scan batch of SCAN_FIXTURE, the stream decoded on the
    card up to it: (packed (K, gh*gw, words) int16 on the card, the
    ring's slots S, gw, gh, chroma_qp_off)."""
    import numpy as np

    from chip_smoke import load_fixture
    from hartallo_tpu_torch.api import Codec, CodecConfig
    from hartallo_tpu_torch.decode import decoder as DM

    class Caught(Exception):
        pass

    def scan(packed, write_slot, has_intra, ringY, *rest, gw, gh,
             chroma_qp_off):
        rows = packed.cpu() if isinstance(packed, torch.Tensor) else packed
        raise Caught(np.asarray(rows, np.int16), ringY.shape[0], gw, gh,
                     chroma_qp_off)
    real, DM.decode_gop = DM.decode_gop, scan
    try:
        Codec(CodecConfig(), device="cuda").decode_annexb(
            load_fixture(SCAN_FIXTURE)[0], tolerant=False)
    except Caught as c:
        packed, S, gw, gh, cqo = c.args
        return torch.tensor(packed, device="cuda"), S, gw, gh, cqo
    finally:
        DM.decode_gop = real
    raise SystemExit(f"port_kernel_times: {SCAN_FIXTURE} sent no picture "
                     "to the GOP scan")


def time_scan(res: dict) -> None:
    """The GOP scan's kernels' entries of ``res`` (see the top)."""
    import numpy as np
    import torch

    from chip_smoke import (MC_DEC_CASES, MC_DEC_TIMED, MC_KERNELS, SEED,
                            deblock_rec_inputs, kernel_alone,
                            mc_dec_inputs, params_dec_bound,
                            residual_dec_bound, residual_rec_inputs,
                            ring_write_inputs, scan_kernels)
    from hartallo_tpu_torch.decode import mc_decode_fast as M
    from chip_smoke import RESIDUAL_NAMES
    from hartallo_tpu_torch.decode.d_fused import DEC_FIELDS
    from hartallo_tpu_torch.decode.d_gop import (_QUAD, DEBLOCK_OFFSETS,
                                                 prepare_pictures,
                                                 ring_shapes)
    from hartallo_tpu_torch.ops import deblock_fast as D
    out = {f"{n}_{k}": res.setdefault(f"{n}_{k}", {})
           for n in (*MC_KERNELS, "deblock_params_dec")
           for k in ("us", "kernel_us", "host_us", "plain_us", "bound_us")}
    # a tree whose kernels read the int16 records as uploaded (and the
    # residual nnz); an older one reads them widened to int32
    int16 = len(M.RESIDUAL_FIELDS) == 7
    RES_OFFS = D.record_offsets(DEC_FIELDS,
                                [(n, None) for n in RESIDUAL_NAMES])[0]

    def cuda(a):
        return torch.tensor(a, device="cuda")

    def record(rec, offs):
        """A record as the tree's wrappers take it: (rec, offs)."""
        if int16:
            return rec, offs
        return rec.to(torch.int32), offs[:6] if len(offs) == 7 else offs

    def put(key, tag, got):
        """A ``chip_smoke.kernel_alone`` result into ``out``."""
        _, ms, dev_us, h_us, plain_ms, (b_ms, _) = got
        for k, v in (("us", 1e3 * ms), ("kernel_us", dev_us),
                     ("host_us", h_us), ("plain_us", 1e3 * plain_ms),
                     ("bound_us", 1e3 * b_ms)):
            out[f"{key}_{k}"][tag] = v

    def alone(key, fast, twin, tag, rec, offs, bound, gw, gh):
        """One kernel on one picture's record (the tree's layout), checked
        against its twin and timed."""
        a = (*record(rec, offs), 0)
        put(key, tag, kernel_alone(torch, tag, key, fast, twin, a, a, bound,
                                   gw, gh))

    def params(tag, gw, gh, rec, offs):
        alone("deblock_params_dec", D.deblock_params_dec_fast,
              D.deblock_params_dec_plain, tag, rec, offs,
              params_dec_bound(gw, gh), gw, gh)

    def seeded_stacks(shapes, dtype, seed):
        rng = np.random.default_rng(seed)
        return [cuda(rng.integers(0, 256, s).astype(dtype)) for s in shapes]

    def timed(tag, gw, gh, rec, offs, mc, planes, S):
        rings = seeded_stacks(ring_shapes(gw, gh, S), np.uint8, SEED)
        row = torch.empty((gh * 24, gw * 16), dtype=torch.uint8,
                          device="cuda")
        got = scan_kernels(torch, tag, gw, gh, *record(rec, offs), mc,
                           (*planes, *rings, S - 1, row),
                           residual_bound=residual_dec_bound(rec, offs))
        for n, r in got.items():
            put(n, tag, r)

    def interiors(pl, gw, gh):
        H, W = gh * 16, gw * 16
        return (pl[0][32:32 + H, 32:32 + W],
                *(p[32:32 + H // 2, 32:32 + W // 2] for p in pl[1:]))
    for k, (label, gw, gh, band) in enumerate(MC_DEC_CASES):
        if label not in MC_DEC_TIMED:
            continue
        rec, offs = residual_rec_inputs(gw, gh, 1, SEED + k)
        mc = [cuda(a) for a in mc_dec_inputs(gw, gh, 3, SEED + k,
                                             band=band)]
        planes = ring_write_inputs(gw, gh, 3, SEED + k)[0]
        timed(f"seeded {label}", gw, gh, cuda(rec), offs, mc,
              interiors([cuda(p) for p in planes], gw, gh), 3)
        # the residual alone on the coded sets; the parameters on the
        # scan's dense buffer
        for coded, tag in ((0.0, "zero-coded"), (0.15, "sparse"),
                           (1.0, "fully coded")):
            rec, offs = residual_rec_inputs(gw, gh, 1, SEED + k,
                                            coded=coded)
            alone("residual_dec", M.residual_planes_fast,
                  M.residual_planes_plain, f"{tag} {label}", cuda(rec), offs,
                  residual_dec_bound(rec, offs), gw, gh)
        rec, offs = deblock_rec_inputs(gw, gh, 1, SEED + k, wide=True)
        params(f"seeded {label}", gw, gh, cuda(rec), offs)
    packed, S, gw, gh, cqo = _scan_batch(torch)
    b = prepare_pictures(packed if int16 else packed.to(torch.int32), gw=gw,
                         gh=gh, chroma_qp_off=cqo)
    res["scan_fixture"] = {"name": SCAN_FIXTURE, "gw": gw, "gh": gh,
                           "S": S, "batch": int(packed.shape[0]),
                           "inter_mbs": int(b["inter"][0].sum())}
    # per-4x4 motion: each block's MV moved by a seeded offset, each
    # quadrant's slot redrawn over two references of a three-slot ring
    rng = np.random.default_rng(SEED)
    n_all = gh * gw * 16
    sub = {"mv": b["mv"][0] + cuda(rng.integers(-16, 17, (n_all, 2)).astype(
               np.int32)),
           "slot": cuda(rng.integers(0, 2, (gh * gw, 4))[:, _QUAD].reshape(
               n_all).astype(np.int32))}
    for label, rows, motion in (("1080p", gh, "fixture"),
                                ("band 120x34", 34, "fixture"),
                                ("1080p", gh, "fixture_4x4"),
                                ("band 120x34", 34, "fixture_4x4")):
        S_run = S if motion == "fixture" else 3
        n = rows * gw * 16
        H, W = rows * 16, gw * 16
        if rows == gh:
            stacks = seeded_stacks(ring_shapes(gw, gh, S_run), np.uint8,
                                   SEED)
        else:
            stacks = seeded_stacks(((S_run, 4, H + 64, W + 64),
                                    (S_run, H // 2 + 64, W // 2 + 64),
                                    (S_run, H // 2 + 64, W // 2 + 64)),
                                   np.int32, SEED)
        fields = {f: (sub[f] if motion == "fixture_4x4" and f in sub
                      else b[f][0]) for f in ("mv", "slot", "wp_l", "wp_c")}
        mc = [*stacks, *(fields[f][:n].contiguous()
                         for f in ("mv", "slot", "wp_l", "wp_c")),
              b["res_y"][0][:H].contiguous(),
              b["res_c"][0][:, :H // 2].contiguous(),
              b["inter"][0][:rows].contiguous()]
        planes = interiors(M.mc_recon_fast(*mc, gw=gw, gh=rows), gw, rows)
        timed(f"{motion} {label}", gw, rows,
              packed[:1, :rows * gw].contiguous(), RES_OFFS, mc,
              planes, S_run)
        if motion == "fixture":
            params(f"fixture {label}", gw, rows,
                   packed[:1, :rows * gw].contiguous(), DEBLOCK_OFFSETS)


def time_kernels(path: str, tree: str, plain: bool,
                 only: str | None = None) -> None:
    """Time the kernels (see the top); ``only`` one of ONLY's keys or None
    for all."""
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
    if only == "dec":
        time_intra_dec(res, plain)
    if only == "scan":
        time_scan(res)
    if only in ("dec", "scan"):
        print(json.dumps(res), flush=True)
        return
    for key, (pay, gw, gh, S) in ({} if only else _payloads(path)).items():
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
    for name, gw, gh, flags in () if only else DEBLOCK_GRIDS:
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
    if only in (None, "intra") and importlib.util.find_spec(
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
    if only in (None, "me") and importlib.util.find_spec(
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
    if only in (None, "p"):
        time_p_body(res, plain)
    if not only and importlib.util.find_spec(
            "hartallo_tpu_torch.decode.intra_recon_fast") is not None:
        time_intra_dec(res, plain)
    if not only and importlib.util.find_spec(
            "hartallo_tpu_torch.decode.mc_decode_fast") is not None:
        time_scan(res)
    print(json.dumps(res), flush=True)


def main(argv) -> None:
    if len(argv) >= 2 and argv[0] == "dump":
        dump(argv[1])
    elif len(argv) >= 2 and argv[0] == "time":
        tree = argv[argv.index("--tree") + 1] if "--tree" in argv else \
            str(REPO)
        only = [m for m in ONLY if f"--{m}-only" in argv]
        if len(only) > 1:
            raise SystemExit(__doc__)
        time_kernels(argv[1], tree, "--plain" in argv,
                     only[0] if only else None)
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main(sys.argv[1:])
