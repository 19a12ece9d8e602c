"""Command line of the port — the counterpart of ``tools/hartallo_cli.py``
(the reference's test_decoder/test_encoder apps), on a torch device.

Usage:
  python -m hartallo_tpu_torch.cli decode <in.264> <out.yuv>
      [--dqid-min N] [--dqid-max N] [--md5] [--device DEV]
  python -m hartallo_tpu_torch.cli encode <in.yuv> <W> <H> <out.264>
      [--qp N] [--gop N] [--frames N] [--bitrate BPS] [--no-deblock]
      [--me-range N] [--slices N] [--threads N] [--quality-layers N]
      [--quality-qp-delta N] [--device DEV]
  python -m hartallo_tpu_torch.cli encode-svc <base.yuv> <W0> <H0>
      <enh.yuv> <W1> <H1> <out.264> [--qp N] [--gop N] [--frames N]
      [--device DEV]

Each command prints one JSON line.  ``--device`` is ``cuda`` (the card)
unless another torch device is named, e.g. ``cpu``.
"""
import argparse
import json
import sys
import time

import numpy as np

from hartallo_tpu_torch.api import Codec, CodecConfig
from hartallo_tpu_torch.util.checks import frame_md5


def _sync(device) -> None:
    """Wait for the device, so that a time covers its work."""
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def cmd_decode(args):
    data = open(args.input, "rb").read()
    codec = Codec(CodecConfig(dqid_min=args.dqid_min,
                              dqid_max=args.dqid_max), device=args.device)
    t0 = time.perf_counter()
    results = codec.decode_annexb(data)
    _sync(args.device)
    dt = time.perf_counter() - t0
    with open(args.output, "wb") as f:
        for r in results:
            f.write(r.frame.astype(np.uint8).tobytes())
            if args.md5:
                print("MD5", frame_md5(r.frame, r.width, r.height),
                      file=sys.stderr)
    print(json.dumps({"op": "decode", "frames": len(results),
                      "seconds": round(dt, 3),
                      "fps": round(len(results) / dt, 2) if dt else 0,
                      "device": args.device}))


def cmd_encode(args):
    W, H = args.width, args.height
    fsz = W * H * 3 // 2
    cfg = CodecConfig(width=W, height=H, qp=args.qp, gop_size=args.gop,
                      deblock=not args.no_deblock, me_range=args.me_range,
                      rc_bitrate=args.bitrate, slices=args.slices,
                      threads=args.threads,
                      quality_layers=args.quality_layers,
                      quality_qp_delta=args.quality_qp_delta)
    codec = Codec(cfg, device=args.device)
    n = 0
    t0 = time.perf_counter()
    with open(args.input, "rb") as fi, open(args.output, "wb") as fo:
        while n < args.frames:
            raw = fi.read(fsz)
            if len(raw) < fsz:
                break
            r = codec.encode(np.frombuffer(raw, np.uint8), W, H)
            fo.write(r.headers + r.data)
            n += 1
    _sync(args.device)
    dt = time.perf_counter() - t0
    print(json.dumps({"op": "encode", "frames": n,
                      "seconds": round(dt, 3),
                      "fps": round(n / dt, 2) if dt else 0,
                      "device": args.device}))


def cmd_encode_svc(args):
    W0, H0, W1, H1 = args.w0, args.h0, args.w1, args.h1
    cfg = CodecConfig(qp=args.qp, gop_size=args.gop, deblock=True,
                      me_range=8)
    cfg.add_layer(W0, H0)
    cfg.add_layer(W1, H1)
    codec = Codec(cfg, device=args.device)
    n = 0
    sz0, sz1 = W0 * H0 * 3 // 2, W1 * H1 * 3 // 2
    with open(args.base, "rb") as f0, open(args.enh, "rb") as f1, \
            open(args.output, "wb") as fo:
        while n < args.frames:
            b = f0.read(sz0)
            e = f1.read(sz1)
            if len(b) < sz0 or len(e) < sz1:
                break
            r0 = codec.encode(np.frombuffer(b, np.uint8), W0, H0)
            fo.write(r0.headers + r0.data)
            r1 = codec.encode(np.frombuffer(e, np.uint8), W1, H1)
            fo.write(r1.headers + r1.data)
            n += 1
    print(json.dumps({"op": "encode-svc", "frames": n,
                      "device": args.device}))


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m hartallo_tpu_torch.cli")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("decode")
    d.add_argument("input")
    d.add_argument("output")
    d.add_argument("--dqid-min", type=int, default=-1)
    d.add_argument("--dqid-max", type=int, default=-1)
    d.add_argument("--md5", action="store_true")
    d.set_defaults(fn=cmd_decode)

    e = sub.add_parser("encode")
    e.add_argument("input")
    e.add_argument("width", type=int)
    e.add_argument("height", type=int)
    e.add_argument("output")
    e.add_argument("--qp", type=int, default=30)
    e.add_argument("--gop", type=int, default=30)
    e.add_argument("--frames", type=int, default=1 << 30)
    e.add_argument("--bitrate", type=int, default=-1)
    e.add_argument("--me-range", type=int, default=16)
    e.add_argument("--no-deblock", action="store_true")
    e.add_argument("--slices", type=int, default=1,
                   help="slices per frame (contiguous MB-row ranges)")
    e.add_argument("--threads", type=int, default=1,
                   help="host entropy-packing workers")
    e.add_argument("--quality-layers", type=int, default=1,
                   help="2 = emit a quality_id=1 refinement NAL per "
                        "picture (SVC quality scalability)")
    e.add_argument("--quality-qp-delta", type=int, default=6)
    e.set_defaults(fn=cmd_encode)

    s = sub.add_parser("encode-svc")
    s.add_argument("base")
    s.add_argument("w0", type=int)
    s.add_argument("h0", type=int)
    s.add_argument("enh")
    s.add_argument("w1", type=int)
    s.add_argument("h1", type=int)
    s.add_argument("output")
    s.add_argument("--qp", type=int, default=30)
    s.add_argument("--gop", type=int, default=8)
    s.add_argument("--frames", type=int, default=1 << 30)
    s.set_defaults(fn=cmd_encode_svc)

    for cmd in (d, e, s):
        cmd.add_argument("--device", default="cuda",
                         help="torch device to run on (default: cuda)")

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
