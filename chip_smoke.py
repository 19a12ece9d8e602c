"""Drive the PyTorch port of the codec on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. stop at once when torch sees no CUDA device; print the card's name
   and power limit (``nvidia-smi``);
2. build both CUDA kernels from ``hartallo_tpu_torch/csrc`` into
   ``build/kernels/`` (one ``nvcc`` per source, all at once) and print
   ptxas' registers and spills;
3. GOP kernel phase: the ``d_pool.pack_fast`` payloads of the 16 pictures
   of ``tests/data/port/cif_16.264`` and a seeded synthetic ring go
   through the whole-GOP decode kernel and through its plain torch
   version on the card; the outputs and ring slots must be byte-equal for
   the stages m, mr, mri and mriwdsoh;
4. deblock kernel phase: seeded planes, bS in 0..4, QPs and nonzero
   alpha/beta offsets at the CIF, 720p and 1080p MB grids go through the
   frame deblock kernel and its plain twin; the planes must be byte-equal;
5. decode slice phase (the decode path): ``Codec(..., device="cuda")``
   decodes the CIF and 720p fixtures, launch counts set to 0 just before;
   every frame's MD5 must equal the one the JAX package recorded, all 16
   CIF pictures must take the GOP kernel and at least one 720p picture
   must, and every 720p picture of the GOP scan must have launched the
   deblock kernel;
6. encode phase (the encode path): ``Codec(CodecConfig(W, H, qp=30,
   gop_size=NF, deblock=True, me_range=12), device="cuda").encode_frames``
   of ``bench.make_clip`` at CIF 16 and 720p 8, launch counts set to 0
   just before; each stream must equal the JAX package's fixture byte for
   byte, the deblock kernel must have run once per picture, and the
   port's decoder must decode the port's streams to the recorded MD5s;
7. timings (not claims), CUDA events for kernels and host clocks around
   synchronised runs: kernel vs plain time per CIF picture and per
   deblocked frame (the deblock wrapper with its parameter gather, and
   the launch alone); encode and decode fps at CIF and 720p, best and
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


def fast_frames(stream: bytes, device):
    """Parse a stream with the port's decoder and return the kernel
    payloads of its pictures (nothing is decoded)."""
    from hartallo_tpu_torch.decode.decoder import Decoder
    dec = Decoder(device=device, batch_k=1 << 30)
    dec.enqueue_annexb(stream, tolerant=False)
    jobs = dec.layer.jobs
    if any(j.fast is None for j in jobs):
        raise SystemExit("kernel phase: a CIF picture is not eligible")
    gw, gh, S, _ = dec.layer.ring_key
    return [j.fast for j in jobs], gw, gh, S


def kernel_phase(torch, card):
    from hartallo_tpu_torch.decode import d_gop_fast as F
    from hartallo_tpu_torch.decode.d_gop import ring_shapes
    import numpy as np

    stream, _ = load_fixture("cif_16")
    frames, gw, gh, S = fast_frames(stream, "cuda")
    pay = F.payload_to(F.stack_payload(frames), "cuda")
    rng = np.random.default_rng(SEED)
    ring0 = tuple(rng.integers(0, 256, s, dtype=np.uint8)
                  for s in ring_shapes(gw, gh, S))
    Hp, Wp = gh * 16 + 64, gw * 16 + 64
    Hcp, Wcp = gh * 8 + 64, gw * 8 + 64
    args = [pay[k] for k in ("smb", "aux", "sf", "tags", "vals", "ilist",
                             "ivals")]
    max_err = 0
    for stages in STAGES:
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
        print(f"kernel phase stages={stages}: byte-equal={same} "
              f"max_abs_err={err}", flush=True)
        if not same:
            raise SystemExit(f"kernel != plain for stages {stages}")
        max_err = max(max_err, err)

    # kernel vs plain time per CIF picture, full stages, CUDA events
    K = len(frames)

    def timed(fn, reps):
        rings = F.rings_from_numpy(*ring0, "cuda")
        fn(*args, *rings, gw=gw, gh=gh, stages="mriwdsoh")     # warm-up
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn(*args, *rings, gw=gw, gh=gh, stages="mriwdsoh")
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / (reps * K)
    ms = timed(F.decode_gop_fast, 10)
    plain_ms = timed(F.decode_gop_fast_plain, 1)
    print(f"[{card}] CIF kernel {ms * 1e3:.1f} us/picture, plain torch "
          f"{plain_ms * 1e3:.1f} us/picture ({K} pictures per call)",
          flush=True)
    return max_err, ms, plain_ms


def deblock_inputs(gw, gh, seed):
    """Seeded planes, bS in 0..4 (picture edges 0, as every caller keeps
    them), QPs and nonzero alpha/beta offsets, as numpy int32: the inputs
    of tests/test_deblock_pallas.py."""
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
    return planes, rest


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


def deblock_phase(torch, card):
    """The frame deblock kernel against its plain twin at the CIF, 720p
    and 1080p (1088 coded rows) MB grids; returns (max_abs_err, ms per
    frame of kernel and plain at 720p, the geometry the encode path
    deblocks most)."""
    from hartallo_tpu_torch.ops import deblock_fast as D
    from hartallo_tpu_torch.ops.deblock import edge_params
    max_err, times = 0, {}
    for name, (gw, gh) in (("CIF", (22, 18)), ("720p", (80, 45)),
                           ("1080p", (120, 68))):
        planes, rest = deblock_inputs(gw, gh, SEED + gw)
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
        times[name] = (ms, plain_ms)
        print(f"[{card}] deblock {name}: kernel {ms * 1e3:.1f} us/frame "
              f"(launch alone, parameters gathered before: "
              f"{launch_ms * 1e3:.1f}), plain torch {plain_ms * 1e3:.1f} "
              "us/frame", flush=True)
    return max_err, times["720p"]


def decode_fixture(torch, name):
    from hartallo_tpu_torch.api import Codec, CodecConfig
    stream, meta = load_fixture(name)
    codec = Codec(CodecConfig(), device="cuda")
    t0 = time.perf_counter()
    out = codec.decode_annexb(stream, tolerant=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    md5 = [frame_md5(r.frame) for r in out]
    if md5 != meta["frame_md5"]:
        bad = [i for i, (a, b) in enumerate(zip(md5, meta["frame_md5"]))
               if a != b]
        raise SystemExit(f"{name}: {len(out)} frames, MD5 mismatch at "
                         f"{bad or 'frame count'}")
    return codec.decoder.stats, dt, meta["frames"]


def slice_phase(torch):
    """The decode path, launch counts set to 0 just before it."""
    from hartallo_tpu_torch.decode import d_gop_fast as F
    from hartallo_tpu_torch.ops import deblock_fast as D
    F.LAUNCHES = D.LAUNCHES = 0
    cif, _, _ = decode_fixture(torch, "cif_16")
    hd, _, _ = decode_fixture(torch, "720p_8")
    launches, db = F.LAUNCHES, D.LAUNCHES
    print(f"slice phase: cif_16 {cif}, 720p_8 {hd}, GOP kernel launches "
          f"(pictures) {launches}, deblock kernel launches {db}",
          flush=True)
    if cif["kernel_pictures"] != 16 or cif["scan_pictures"] != 0:
        raise SystemExit(f"cif_16: expected 16 kernel pictures, got {cif}")
    if hd["kernel_pictures"] < 1 or hd["scan_pictures"] < 1 or \
            hd["kernel_pictures"] + hd["scan_pictures"] != 8:
        raise SystemExit(f"720p_8: bad routing {hd}")
    if launches != cif["kernel_pictures"] + hd["kernel_pictures"]:
        raise SystemExit(f"GOP kernel launches {launches} do not match the "
                         "pictures routed to it")
    if db != hd["scan_pictures"]:
        raise SystemExit(f"deblock kernel launches {db} do not match the "
                         f"{hd['scan_pictures']} GOP-scan pictures")
    return launches


def encode_clip(torch, name):
    """Encode a fixture's clip on the card with bench.py's settings;
    returns (stream, seconds, metadata)."""
    from bench import make_clip
    from hartallo_tpu_torch.api import Codec, CodecConfig
    _, meta = load_fixture(name)
    W, H, NF = meta["width"], meta["height"], meta["frames"]
    clip = make_clip(W, H, NF)
    codec = Codec(CodecConfig(width=W, height=H, qp=30, gop_size=NF,
                              deblock=True, me_range=12), device="cuda")
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
        out = Codec(CodecConfig(), device="cuda").decode_annexb(
            stream, tolerant=False)
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
    from hartallo_tpu_torch import kernels
    t0 = time.perf_counter()
    lib = kernels.build()
    print(f"built {lib.relative_to(REPO)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in kernels.BUILD_LOG.splitlines():
        if line.startswith("== ") or "Compiling entry" in line or \
                "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)
    max_err, ms, plain_ms = kernel_phase(torch, card)
    db_err, (db_ms, db_plain_ms) = deblock_phase(torch, card)
    launches = slice_phase(torch)
    db_launches = encode_phase(torch)
    encode_fps(torch, "cif_16", card)
    encode_fps(torch, "720p_8", card)
    fps(torch, "cif_16", card)
    fps(torch, "720p_8", card)
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - started:.1f} s", flush=True)
    print(json.dumps({"kernels": [
        {"name": "decode_gop_fast", "route": "cuda",
         "source": "hartallo_tpu_torch/csrc/d_gop.cu",
         "replaces": "hartallo_tpu/decode/d_gop_pallas.py:1048",
         "launches": launches, "max_abs_err": max_err,
         "ms": ms, "plain_ms": plain_ms},
        {"name": "deblock_frame_fast", "route": "cuda",
         "source": "hartallo_tpu_torch/csrc/deblock.cu",
         "replaces": "hartallo_tpu/ops/deblock_pallas.py:349",
         "launches": db_launches, "max_abs_err": db_err,
         "ms": db_ms, "plain_ms": db_plain_ms}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
