"""Write the decode fixtures of the PyTorch port (``tests/data/port/``).

The streams and checksums written here are the JAX package's output:
``bench.make_clip`` is encoded by ``hartallo_tpu`` with bench.py's own
settings (qp 30, ``gop_size`` = frame count so one IDR picture is followed
by P pictures, deblocking on, ``me_range`` 12), and the stream is decoded
back by ``hartallo_tpu`` on the CPU.  For each stream the script writes
``<name>.264`` and ``<name>.json`` (config, frame count and each decoded
frame's ``util.checks.plane_md5``).  ``hartallo_tpu_torch``'s tests and
``chip_smoke.py`` decode these streams and hold every frame to its MD5;
the machine with the GPU has no JAX, so the streams live in the repo.

Rerun the script whenever the encoder or the decoder of ``hartallo_tpu``
changes:

    python tools/make_port_fixtures.py            # all fixtures
    python tools/make_port_fixtures.py qcif_8     # some of them

Besides the bench clip at QCIF, CIF, 720p and 1080p (1920x1080, 1088
coded rows), small QCIF streams cover the batched path's stream classes:
three slices per picture, FMO slice groups, no deblocking across slice
edges, non-reference P pictures (two temporal layers), and a plain
6-picture stream that the tests rewrite into DPB and weighted-prediction
variants.  One such rewrite is stored too: ``qcif_6_wp``, ``qcif_6`` with
explicit weighted prediction on every P slice
(``tests/_torch_port.weighted_rewrite``), a stream whose P pictures the
GOP kernel refuses, so ``chip_smoke.py`` keeps the GOP scan measured on
the card.
"""
from __future__ import annotations

import json
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
OUT = REPO / "tests" / "data" / "port"

# name -> (width, height, frames, CodecConfig settings beyond bench.py's)
FIXTURES = {
    "qcif_8": (176, 144, 8, {}),
    "cif_16": (352, 288, 16, {}),
    "720p_8": (1280, 720, 8, {}),
    "1080p_8": (1920, 1080, 8, {}),
    # the base of the DPB and weighted-prediction rewrites of
    # tests/test_torch_batched_streams.py
    "qcif_6": (176, 144, 6, {}),
    # stream classes of the batched path: slices, FMO slice groups,
    # no deblocking across slice edges, non-reference pictures
    "qcif_6_slices3": (176, 144, 6, {"slices": 3}),
    "qcif_6_fmo1": (176, 144, 6, {"num_slice_groups": 2,
                                  "slice_group_map_type": 1}),
    "qcif_6_idc2": (176, 144, 6, {"slices": 3,
                                  "deblock_slice_edges": False}),
    "qcif_6_tl2": (176, 144, 6, {"temporal_layers": 2}),
}
# name -> (base fixture, function of tests/_torch_port.py rewriting it)
REWRITES = {"qcif_6_wp": ("qcif_6", "weighted_rewrite")}
QP = 30
ME_RANGE = 12
MAX_BYTES = 1 << 20


def _decode_and_write(name: str, stream: bytes, meta: dict) -> dict:
    """Decode ``stream`` with ``hartallo_tpu``, record each frame's MD5 and
    write the pair of files."""
    from hartallo_tpu.api import Codec, CodecConfig
    from hartallo_tpu.util.checks import plane_md5

    if len(stream) > MAX_BYTES:
        raise SystemExit(f"{name}: stream of {len(stream)} bytes is over "
                         f"{MAX_BYTES}")
    out = Codec(CodecConfig()).decode_annexb(stream, tolerant=False)
    if len(out) != meta["frames"]:
        raise SystemExit(f"{name}: decoded {len(out)} of {meta['frames']} "
                         "frames")
    meta = {**meta, "bytes": len(stream),
            "frame_md5": [plane_md5(r.frame) for r in out]}
    (OUT / f"{name}.264").write_bytes(stream)
    (OUT / f"{name}.json").write_text(json.dumps(meta, indent=1) + "\n")
    return meta


def make_rewrite(name: str) -> dict:
    """A stored rewrite of a stored fixture, decoded by ``hartallo_tpu``."""
    sys.path.insert(0, str(REPO / "tests"))
    import _torch_port

    base, fn = REWRITES[name]
    meta = json.loads((OUT / f"{base}.json").read_text())
    stream = getattr(_torch_port, fn)((OUT / f"{base}.264").read_bytes())
    meta = {k: v for k, v in meta.items() if k not in ("bytes",
                                                       "frame_md5")}
    return _decode_and_write(name, stream, {**meta, "rewrite_of": base,
                                            "rewrite": fn})


def make(name: str) -> dict:
    from bench import make_clip
    from hartallo_tpu.api import Codec, CodecConfig

    if name in REWRITES:
        return make_rewrite(name)
    W, H, NF, extra = FIXTURES[name]
    enc = Codec(CodecConfig(width=W, height=H, qp=QP, gop_size=NF,
                            deblock=True, me_range=ME_RANGE, **extra))
    if extra:
        results = [enc.encode(f, W, H) for f in make_clip(W, H, NF)]
    else:
        results = enc.encode_frames(make_clip(W, H, NF), W, H)
    stream = b"".join(r.headers + r.data for r in results)
    return _decode_and_write(name, stream, {
        "width": W, "height": H, "frames": NF, "qp": QP, "gop_size": NF,
        "deblock": True, "me_range": ME_RANGE, **extra,
        "clip": "bench.make_clip"})


def main(names) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(REPO))
    OUT.mkdir(parents=True, exist_ok=True)
    for name in names or [*FIXTURES, *REWRITES]:
        meta = make(name)
        print(name, meta["bytes"], "bytes", meta["frames"], "frames",
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
