"""Drive the PyTorch port of the codec on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. stop at once when torch sees no CUDA device; print the card's name
   and power limit (``nvidia-smi``);
2. build both CUDA kernels from ``hartallo_tpu_torch/csrc`` into
   ``build/kernels/`` (one ``nvcc`` per source, all at once) and print
   ptxas' registers and spills; the port's native slice parser and packer
   (``hartallo_tpu_torch/native``, built with gcc into ``build/native/``)
   must have loaded, or the timed host path would be pure Python;
3. GOP kernel phase: the ``d_pool.pack_fast`` payloads of the 16 pictures
   of ``tests/data/port/cif_16.264`` (stages m, mr, mri, mriwdsoh) and of
   the IDR picture of ``720p_8.264`` (3,600 intra MBs; stages mri and
   mriwdsoh), on a seeded synthetic ring, go through the whole-GOP decode
   kernel and its plain torch version on the card; outputs and ring slots
   must be byte-equal;
4. deblock kernel phase: seeded planes, bS in 0..4, QPs and nonzero
   alpha/beta offsets at the CIF, 720p and 1080p MB grids, and at the
   720p grid with slice-edge (idc 2) and idc 1 filter flags, go through
   the frame deblock kernel and its plain twin; the planes must be
   byte-equal;
5. decode slice phase (the decode path): ``Codec(CodecConfig())``, on
   its default device, the card, decodes the CIF, 720p and 1080p
   fixtures, launch counts set to 0 just before; every frame's MD5 must
   equal the one the JAX package recorded and every picture must take
   the GOP kernel;
6. scan phase (the GOP-scan route): the weighted-prediction fixture
   ``qcif_6_wp`` decodes to its MD5s with 1 kernel and 5 scan pictures,
   each scan picture deblocked by one deblock kernel launch;
7. encode phase (the encode path): ``Codec(CodecConfig(W, H, qp=30,
   gop_size=NF, deblock=True, me_range=12)).encode_frames`` of
   ``bench.make_clip`` at CIF 16 and 720p 8 on the card, launch counts
   set to 0 just before; each stream must equal the JAX package's fixture
   byte for byte, the deblock kernel must have run once per picture, and
   the port's decoder must decode the port's streams to the recorded
   MD5s;
8. timings (not claims), CUDA events for kernels and host clocks around
   synchronised runs: kernel and plain time per CIF picture and the
   kernel's time on the 720p IDR picture; per deblocked frame, the
   wrapper with its parameter gather, the launch alone and the plain
   twin; each beside its bound (``gop_bound``, ``deblock_bound``); encode
   fps at CIF and 720p and decode fps at CIF, 720p and 1080p, best and
   worst of 3 after a warm-up (for the encode, the encode phase's run).

The second-to-last line is one JSON object describing the kernels, and
the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
FIXTURES = REPO / "tests" / "data" / "port"
STAGES = ("m", "mr", "mri", "mriwdsoh")
SEED = 1234
# the deblock grids: CIF, 720p, 1080p (1088 coded rows) and 720p with
# slice-edge and idc 1 filter flags
DEBLOCK_GRIDS = (("CIF", 22, 18, False), ("720p", 80, 45, False),
                 ("1080p", 120, 68, False), ("720p slices", 80, 45, True))
# NVIDIA's data sheet for the H100 SXM at 700 W: HBM3 rate, and the
# float32 rate outside the tensor cores, the nearest published rate for
# the kernels' int32 arithmetic (their integer rate is no higher, so the
# bound stays a lower bound)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12


def bound(nbytes: float, ops: float):
    """(ms, "bytes" or "operations"): the least time the card could take
    to move ``nbytes`` and do ``ops``."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def gop_bound(pay, gw: int, gh: int):
    """Bound of the GOP kernel per picture of the numpy payload ``pay``:
    each picture's payload rows in use, one reference sample per
    predicted sample of its inter MBs, the ring slot and the output it
    writes; operations: the half-pel filters, 18 multiply-adds per
    padded luma sample (b and h from G, j from b)."""
    H, W, nmb = gh * 16, gw * 16, gw * gh
    Hp, Wp, Hcp, Wcp = H + 64, W + 64, H // 2 + 64, W // 2 + 64
    K = pay["sf"].shape[0]
    nbytes = ops = 0
    for k in range(K):
        nr, ni = int(pay["sf"][k, 4]), int(pay["sf"][k, 5])
        nbytes += pay["smb"][k].nbytes + pay["aux"][k].nbytes + \
            pay["sf"][k].nbytes + nr * (4 + 16 * 2) + ni * (16 + 24 * 16 * 2)
        nbytes += (nmb - ni) * 384
        nbytes += 4 * Hp * Wp + 2 * Hcp * Wcp + (H + H // 2) * W
        ops += 36 * Hp * Wp
    ms, by = bound(nbytes, ops)
    return ms / K, by


def deblock_bound(planes, rest):
    """Bound of one ``deblock_frame_fast`` call on numpy inputs: the
    planes read and written, the bS and QP maps read; operations: about
    30 per line through an edge with bS > 0 (4 luma lines per bS entry,
    2 lines of each chroma plane per entry of luma edges 0 and 2)."""
    bs_v, bs_h = rest[0], rest[1]
    nbytes = 2 * sum(p.nbytes for p in planes) + sum(a.nbytes for a in rest)
    lines = sum(4 * int((b > 0).sum()) + 4 * int((b[:, :, 0::2] > 0).sum())
                for b in (bs_v, bs_h))
    return bound(nbytes, 30 * lines)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def frame_md5(frame) -> str:
    """MD5 of a decoded frame's bytes, as the fixtures record it."""
    return hashlib.md5(frame.astype("uint8").tobytes()).hexdigest()


def load_fixture(name):
    meta = json.loads((FIXTURES / f"{name}.json").read_text())
    return (FIXTURES / f"{name}.264").read_bytes(), meta


def fast_frames(name: str, device):
    """Parse a fixture with the port's decoder and return the kernel
    payloads of its pictures and its geometry (nothing is decoded)."""
    from hartallo_tpu_torch.decode.decoder import Decoder
    dec = Decoder(device=device, batch_k=1 << 30)
    dec.enqueue_annexb(load_fixture(name)[0], tolerant=False)
    jobs = dec.layer.jobs
    if any(j.fast is None for j in jobs):
        raise SystemExit(f"kernel phase: a {name} picture is not eligible")
    gw, gh, S, _ = dec.layer.ring_key
    return [j.fast for j in jobs], gw, gh, S


def event_ms(torch, fn, reps):
    """Mean ms of fn() over reps calls after one warm-up, CUDA events."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def check_gop(torch, frames, gw, gh, S, stages_list, label):
    """The GOP kernel against its plain twin on the card for each stage
    set, on a seeded ring; returns (max_abs_err, numpy payload, the
    kernel's and the twin's arguments and a fresh-ring maker)."""
    from hartallo_tpu_torch.decode import d_gop_fast as F
    from hartallo_tpu_torch.decode.d_gop import ring_shapes
    import numpy as np

    host = F.stack_payload(frames)
    pay = F.payload_to(host, "cuda")
    rng = np.random.default_rng(SEED)
    ring0 = tuple(rng.integers(0, 256, s, dtype=np.uint8)
                  for s in ring_shapes(gw, gh, S))
    Hp, Wp = gh * 16 + 64, gw * 16 + 64
    Hcp, Wcp = gh * 8 + 64, gw * 8 + 64
    args = [pay[k] for k in ("smb", "aux", "sf", "tags", "vals", "ilist",
                             "ivals")]
    max_err = 0
    for stages in stages_list:
        rk = F.rings_from_numpy(*ring0, "cuda")
        rp = F.rings_from_numpy(*ring0, "cuda")
        ok_, *rk = F.decode_gop_fast(*args, *rk, gw=gw, gh=gh,
                                     stages=stages)
        op, *rp = F.decode_gop_fast_plain(*args, *rp, gw=gw, gh=gh,
                                          stages=stages)
        torch.cuda.synchronize()
        err = int((ok_.int() - op.int()).abs().max())
        same = torch.equal(ok_, op) and \
            torch.equal(rk[0][:, :, :Hp, :Wp], rp[0][:, :, :Hp, :Wp]) and \
            all(torch.equal(a[:, :Hcp, :Wcp], b[:, :Hcp, :Wcp])
                for a, b in zip(rk[1:], rp[1:]))
        print(f"kernel phase {label} stages={stages}: byte-equal={same} "
              f"max_abs_err={err}", flush=True)
        if not same:
            raise SystemExit(f"kernel != plain for {label}, stages {stages}")
        max_err = max(max_err, err)
    return max_err, host, args, lambda: F.rings_from_numpy(*ring0, "cuda")


def kernel_phase(torch, card):
    """The GOP kernel against its twin: the 16 pictures of cif_16 at every
    stage set, and the IDR picture of 720p_8 (3,600 intra MBs) at mri and
    mriwdsoh; then kernel and twin times per CIF picture and the kernel's
    time on the 720p IDR picture."""
    from hartallo_tpu_torch.decode import d_gop_fast as F

    frames, gw, gh, S = fast_frames("cif_16", "cuda")
    err, host, args, rings = check_gop(torch, frames, gw, gh, S, STAGES,
                                       "cif_16")
    hd, hgw, hgh, hS = fast_frames("720p_8", "cuda")
    hd_err, _, hd_args, hd_rings = check_gop(
        torch, hd[:1], hgw, hgh, hS, ("mri", "mriwdsoh"), "720p_8 IDR")
    K = len(frames)
    rk, rp, rh = rings(), rings(), hd_rings()
    ms = event_ms(torch, lambda: F.decode_gop_fast(*args, *rk, gw=gw,
                                                   gh=gh), 10) / K
    plain_ms = event_ms(torch, lambda: F.decode_gop_fast_plain(
        *args, *rp, gw=gw, gh=gh), 1) / K
    hd_ms = event_ms(torch, lambda: F.decode_gop_fast(
        *hd_args, *rh, gw=hgw, gh=hgh), 3)
    bound_ms, bound_by = gop_bound(host, gw, gh)
    print(f"[{card}] GOP kernel: CIF {ms * 1e3:.1f} us/picture, plain torch "
          f"{plain_ms * 1e3:.1f} us/picture ({K} pictures per call), bound "
          f"{bound_ms * 1e3:.3f} us/picture ({bound_by}); 720p IDR picture "
          f"{hd_ms * 1e3:.1f} us", flush=True)
    return max(err, hd_err), ms, plain_ms, bound_ms, bound_by


def deblock_inputs(gw, gh, seed, flags=False):
    """Seeded planes, bS in 0..4 (picture edges 0, as every caller keeps
    them), QPs and nonzero alpha/beta offsets, as numpy int32: the inputs
    of tests/test_deblock_pallas.py.  With ``flags``, the filter flags of
    slices of a few MB rows: no filtering across every other slice edge
    (disable_deblocking_filter_idc 2: bS 0 on the top edge of the slice's
    first row) and none at all in some MBs (idc 1)."""
    import numpy as np
    H, W = gh * 16, gw * 16
    rng = np.random.default_rng(seed)
    planes = tuple(rng.integers(0, 256, (h + 64, w + 64)).astype(np.int32)
                   for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2)))
    bs_v = rng.integers(0, 5, (gh, gw, 4, 4)).astype(np.int32)
    bs_h = rng.integers(0, 5, (gh, gw, 4, 4)).astype(np.int32)
    bs_v[:, 0, 0] = 0
    bs_h[0, :, 0] = 0
    rest = (bs_v, bs_h,
            *[rng.integers(10, 50, (gh, gw)).astype(np.int32)
              for _ in range(3)],
            *[rng.integers(10, 40, (gh, gw)).astype(np.int32)
              for _ in range(3)],
            (rng.integers(-4, 5, (gh, gw)) * 2).astype(np.int32),
            (rng.integers(-4, 5, (gh, gw)) * 2).astype(np.int32))
    if flags:
        first = np.sort(rng.choice(np.arange(1, gh), gh // 3,
                                   replace=False))
        bs_h[first[::2], :, 0] = 0
        off = rng.random((gh, gw)) < 0.1
        bs_v[off] = 0
        bs_h[off] = 0
    return planes, rest


def deblock_phase(torch, card):
    """The frame deblock kernel against its plain twin at DEBLOCK_GRIDS;
    returns (max_abs_err, and at 720p, the geometry the encode path
    deblocks most: the wrapper's and the twin's ms per frame and the
    bound)."""
    from hartallo_tpu_torch.ops import deblock_fast as D
    from hartallo_tpu_torch.ops.deblock import edge_params
    max_err, at720 = 0, None
    for name, gw, gh, flags in DEBLOCK_GRIDS:
        planes, rest = deblock_inputs(gw, gh, SEED + gw, flags)
        tp = tuple(torch.tensor(p, device="cuda") for p in planes)
        ta = tuple(torch.tensor(a, device="cuda") for a in rest)
        got = D.deblock_frame_fast(tp, *ta, gw=gw, gh=gh)
        want = D.deblock_frame_fast_plain(tp, *ta, gw=gw, gh=gh)
        torch.cuda.synchronize()
        err = max(int((g - w).abs().max()) for g, w in zip(got, want))
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        print(f"deblock kernel phase {name} ({gw}x{gh} MBs): "
              f"byte-equal={same} max_abs_err={err}", flush=True)
        if not same:
            raise SystemExit(f"deblock kernel != plain at {name}")
        max_err = max(max_err, err)
        ms = event_ms(torch, lambda: D.deblock_frame_fast(
            tp, *ta, gw=gw, gh=gh), 20)
        aux = edge_params(*ta).to(torch.int16).contiguous()
        launch_ms = event_ms(torch, lambda: D._launch(aux, tp, gw=gw,
                                                      gh=gh), 20)
        plain_ms = event_ms(torch, lambda: D.deblock_frame_fast_plain(
            tp, *ta, gw=gw, gh=gh), 1)
        bound_ms, bound_by = deblock_bound(planes, rest)
        if name == "720p":
            at720 = (ms, plain_ms, bound_ms, bound_by)
        print(f"[{card}] deblock {name}: kernel {ms * 1e3:.1f} us/frame "
              f"(launch alone, parameters gathered before: "
              f"{launch_ms * 1e3:.1f}), plain torch {plain_ms * 1e3:.1f} "
              f"us/frame, bound {bound_ms * 1e3:.3f} us ({bound_by})",
              flush=True)
    return max_err, at720


def decode_fixture(torch, name):
    """Decode a fixture through ``Codec`` on its default device, the card;
    every frame's MD5 must be the recorded one."""
    from hartallo_tpu_torch.api import Codec, CodecConfig
    stream, meta = load_fixture(name)
    codec = Codec(CodecConfig())
    t0 = time.perf_counter()
    out = codec.decode_annexb(stream, tolerant=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if codec.decoder.device.type != "cuda":
        raise SystemExit(f"{name}: Codec decoded on {codec.decoder.device}")
    md5 = [frame_md5(r.frame) for r in out]
    if md5 != meta["frame_md5"]:
        bad = [i for i, (a, b) in enumerate(zip(md5, meta["frame_md5"]))
               if a != b]
        raise SystemExit(f"{name}: {len(out)} frames, MD5 mismatch at "
                         f"{bad or 'frame count'}")
    return codec.decoder.stats, dt, meta["frames"]


DECODE_MAIN = ("cif_16", "720p_8", "1080p_8")


def slice_phase(torch):
    """The decode path, launch counts set to 0 just before it: every
    picture of the CIF, 720p and 1080p fixtures takes the GOP kernel."""
    from hartallo_tpu_torch.decode import d_gop_fast as F
    from hartallo_tpu_torch.ops import deblock_fast as D
    F.LAUNCHES = D.LAUNCHES = 0
    stats = {name: decode_fixture(torch, name)[0] for name in DECODE_MAIN}
    launches, db = F.LAUNCHES, D.LAUNCHES
    print(f"slice phase: {stats}, GOP kernel launches (pictures) "
          f"{launches}, deblock kernel launches {db}", flush=True)
    for name, st in stats.items():
        nf = load_fixture(name)[1]["frames"]
        if st != {"kernel_pictures": nf, "scan_pictures": 0}:
            raise SystemExit(f"{name}: expected {nf} kernel pictures and "
                             f"no scan picture, got {st}")
    if launches != sum(st["kernel_pictures"] for st in stats.values()):
        raise SystemExit(f"GOP kernel launches {launches} do not match the "
                         "pictures routed to it")
    if db != 0:
        raise SystemExit(f"{db} deblock kernel launches with no GOP-scan "
                         "picture")
    return launches


def scan_phase(torch):
    """The GOP-scan route on the card, launch counts set to 0 just before
    it: qcif_6_wp (explicit weighted prediction on its P pictures, which
    the kernel refuses) decodes to its MD5s with 1 kernel and 5 scan
    pictures, each scan picture deblocked by one deblock kernel launch."""
    from hartallo_tpu_torch.decode import d_gop_fast as F
    from hartallo_tpu_torch.ops import deblock_fast as D
    F.LAUNCHES = D.LAUNCHES = 0
    st, _, _ = decode_fixture(torch, "qcif_6_wp")
    launches, db = F.LAUNCHES, D.LAUNCHES
    print(f"scan phase: qcif_6_wp {st}, GOP kernel launches {launches}, "
          f"deblock kernel launches {db}", flush=True)
    if st != {"kernel_pictures": 1, "scan_pictures": 5}:
        raise SystemExit(f"qcif_6_wp: expected 1 kernel / 5 scan pictures, "
                         f"got {st}")
    if launches != 1 or db != 5:
        raise SystemExit(f"qcif_6_wp: {launches} GOP kernel and {db} "
                         "deblock kernel launches, expected 1 and 5")


def encode_clip(torch, name):
    """Encode a fixture's clip on the card with bench.py's settings;
    returns (stream, seconds, metadata)."""
    from bench import make_clip
    from hartallo_tpu_torch.api import Codec, CodecConfig
    _, meta = load_fixture(name)
    W, H, NF = meta["width"], meta["height"], meta["frames"]
    clip = make_clip(W, H, NF)
    codec = Codec(CodecConfig(width=W, height=H, qp=30, gop_size=NF,
                              deblock=True, me_range=12))
    t0 = time.perf_counter()
    res = codec.encode_frames(clip, W, H)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return b"".join(r.headers + r.data for r in res), dt, meta


def encode_phase(torch):
    """The encode path, launch counts set to 0 just before it; then the
    port's decoder reads the port's streams back."""
    from hartallo_tpu_torch.api import Codec, CodecConfig
    from hartallo_tpu_torch.ops import deblock_fast as D
    from hartallo_tpu_torch.decode import d_gop_fast as F
    F.LAUNCHES = D.LAUNCHES = 0
    streams = {name: encode_clip(torch, name) for name in ("cif_16",
                                                           "720p_8")}
    launches = D.LAUNCHES
    pictures = sum(m["frames"] for _, _, m in streams.values())
    print(f"encode phase: {pictures} pictures, deblock kernel launches "
          f"{launches}", flush=True)
    if launches < pictures:
        raise SystemExit(f"deblock kernel launched {launches} times for "
                         f"{pictures} encoded pictures")
    for name, (stream, _, meta) in streams.items():
        want, _ = load_fixture(name)
        if stream != want:
            raise SystemExit(f"{name}: the port's stream ({len(stream)} "
                             f"bytes) differs from the fixture "
                             f"({len(want)} bytes)")
        out = Codec(CodecConfig()).decode_annexb(stream, tolerant=False)
        md5 = [frame_md5(r.frame) for r in out]
        if md5 != meta["frame_md5"]:
            raise SystemExit(f"{name}: the port's decode of its own stream "
                             "misses the recorded MD5s")
        print(f"encode phase {name}: {len(stream)} bytes, byte-equal to "
              f"the fixture; round trip MD5s equal", flush=True)
    return launches


def encode_fps(torch, name, card):
    """Best and worst of 3 encodes; the encode phase's run was the
    warm-up."""
    runs = []
    for _ in range(3):
        _, dt, meta = encode_clip(torch, name)
        runs.append(meta["frames"] / dt)
    print(f"[{card}] {name} port encode fps best {max(runs):.2f} worst "
          f"{min(runs):.2f} (3 runs after a warm-up)", flush=True)


def fps(torch, name, card):
    decode_fixture(torch, name)                                # warm-up
    runs = []
    for _ in range(3):
        _, dt, nf = decode_fixture(torch, name)
        runs.append(nf / dt)
    print(f"[{card}] {name} port decode fps best {max(runs):.2f} worst "
          f"{min(runs):.2f} (3 runs after a warm-up)", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    started = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    sys.path.insert(0, str(REPO))
    from hartallo_tpu_torch import kernels, native
    t0 = time.perf_counter()
    lib = kernels.build()
    print(f"built {lib.relative_to(REPO)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in kernels.BUILD_LOG.splitlines():
        if line.startswith("== ") or "Compiling entry" in line or \
                "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)
    if not native.available():
        raise SystemExit("the port's native slice parser and packer did "
                         "not build or load: the timed path would run the "
                         "pure-Python fallback")
    print(f"native library {pathlib.Path(native._SO).relative_to(REPO)} "
          "loaded", flush=True)
    max_err, ms, plain_ms, bound_ms, bound_by = kernel_phase(torch, card)
    db_err, (db_ms, db_plain_ms, db_bound_ms, db_bound_by) = \
        deblock_phase(torch, card)
    launches = slice_phase(torch)
    scan_phase(torch)
    db_launches = encode_phase(torch)
    encode_fps(torch, "cif_16", card)
    encode_fps(torch, "720p_8", card)
    for name in DECODE_MAIN:
        fps(torch, name, card)
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - started:.1f} s", flush=True)
    print(json.dumps({"kernels": [
        {"name": "decode_gop_fast", "route": "cuda",
         "source": "hartallo_tpu_torch/csrc/d_gop.cu",
         "replaces": "hartallo_tpu/decode/d_gop_pallas.py:1048",
         "launches": launches, "max_abs_err": max_err,
         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
         "bound_by": bound_by, "library_ms": None},
        {"name": "deblock_frame_fast", "route": "cuda",
         "source": "hartallo_tpu_torch/csrc/deblock.cu",
         "replaces": "hartallo_tpu/ops/deblock_pallas.py:349",
         "launches": db_launches, "max_abs_err": db_err,
         "ms": db_ms, "plain_ms": db_plain_ms, "bound_ms": db_bound_ms,
         "bound_by": db_bound_by, "library_ms": None}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
