"""Drive the PyTorch port of the decoder on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. stop at once when torch sees no CUDA device; print the card's name
   and power limit (``nvidia-smi``);
2. build the CUDA kernel from ``hartallo_tpu_torch/csrc`` into
   ``build/kernels/``;
3. kernel phase: the ``d_pool.pack_fast`` payloads of the 16 pictures of
   ``tests/data/port/cif_16.264`` and a seeded synthetic ring go through
   the CUDA kernel and through its plain torch version on the card; the
   outputs and ring slots must be byte-equal for the stages m, mr, mri and
   mriwdsoh;
4. slice phase: ``hartallo_tpu_torch.api.Codec(..., device="cuda")``
   decodes the CIF and 720p fixtures; every frame's MD5 must equal the one
   the JAX package recorded, all 16 CIF pictures must take the kernel and
   at least one 720p picture must; the kernel's launch count over this
   phase must be positive;
5. timings (not claims): decode fps at CIF and 720p, best and worst of 3
   after one warm-up, and kernel vs plain time per CIF picture.

The second-to-last line is one JSON object describing the kernel, and the
last line ``{"ok": true, "device": {...}}``.
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
    from hartallo_tpu_torch.decode import d_gop_fast as F
    F.LAUNCHES = 0
    cif, _, _ = decode_fixture(torch, "cif_16")
    hd, _, _ = decode_fixture(torch, "720p_8")
    launches = F.LAUNCHES
    print(f"slice phase: cif_16 {cif}, 720p_8 {hd}, kernel launches "
          f"(pictures) {launches}", flush=True)
    if cif["kernel_pictures"] != 16 or cif["scan_pictures"] != 0:
        raise SystemExit(f"cif_16: expected 16 kernel pictures, got {cif}")
    if hd["kernel_pictures"] < 1 or \
            hd["kernel_pictures"] + hd["scan_pictures"] != 8:
        raise SystemExit(f"720p_8: bad routing {hd}")
    if launches != cif["kernel_pictures"] + hd["kernel_pictures"]:
        raise SystemExit(f"kernel launches {launches} do not match the "
                         "pictures routed to it")
    return launches


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
    card = card_line()
    print(card, flush=True)
    sys.path.insert(0, str(REPO))
    from hartallo_tpu_torch import kernels
    t0 = time.perf_counter()
    lib = kernels.build()
    print(f"built {lib.relative_to(REPO)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in kernels.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)
    max_err, ms, plain_ms = kernel_phase(torch, card)
    launches = slice_phase(torch)
    fps(torch, "cif_16", card)
    fps(torch, "720p_8", card)
    print(json.dumps({"kernels": [{
        "name": "decode_gop_fast", "route": "cuda",
        "source": "hartallo_tpu_torch/csrc/d_gop.cu",
        "replaces": "hartallo_tpu/decode/d_gop_pallas.py:1048",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
