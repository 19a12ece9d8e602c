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
variants.  Two such rewrites are stored too: ``qcif_6_wp``, ``qcif_6`` with
explicit weighted prediction on every P slice
(``tests/_torch_port.weighted_rewrite``), a stream whose P pictures the
GOP kernel refuses, so ``chip_smoke.py`` keeps the GOP scan measured on
the card; and ``qcif_6_sl``, ``qcif_6`` with non-flat 4x4 scaling lists
(``tests/_torch_port.scaling_list_rewrite``), which the general decode
path decodes.

The SVC fixtures (``SVC``) are encoded picture by picture, every layer in
turn, from the clips of ``tests/_torch_port.layer_clips``
(``bench.make_clip`` at the top layer's size, the lower layers made from
it); their JSON also records each output's DQId and the MD5s of the
``dqid_max=0`` and ``tid_max=0`` decodes.  ``svc3_4cif_8`` is the
three-layer QCIF/CIF/4CIF stream ``chip_smoke.py`` encodes and decodes
on the card; the others are small versions of the configurations of
``tests/test_svc*.py``.  ``pcm_64x48`` is the all-I_PCM picture of
``tests/test_pcm.py``.
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
REWRITES = {"qcif_6_wp": ("qcif_6", "weighted_rewrite"),
            "qcif_6_sl": ("qcif_6", "scaling_list_rewrite")}
# name -> the SVC configuration (tests/_torch_port.svc_config): layers
# lowest first, frames per layer and the CodecConfig settings
SVC = {
    # QCIF/CIF/4CIF dyadic spatial layers with two temporal layers: the
    # layout of the JSVM reference software and the H.264.1 SVC suite
    "svc3_4cif_8": {"layers": [[176, 144], [352, 288], [704, 576]],
                    "frames": 8, "qp": 30, "gop_size": 8, "me_range": 12,
                    "temporal_layers": 2},
    # tests/test_svc.py: two dyadic layers
    "svc_2l_3": {"layers": [[96, 80], [192, 160]], "frames": 3, "qp": 28,
                 "gop_size": 3, "me_range": 8},
    # tests/test_svc_ess.py: ratio 1.5 (extended spatial scalability)
    "svc_ess_4": {"layers": [[96, 64], [144, 96]], "frames": 4, "qp": 28,
                  "gop_size": 4, "me_range": 8},
    # tests/test_svc_inter_layer.py at qp 30, base-mode EP pictures on
    # and off (off: within-layer P pictures after an I_BL IDR picture)
    "svc_il_4": {"layers": [[96, 80], [192, 160]], "frames": 4, "qp": 30,
                 "gop_size": 4, "me_range": 8},
    "svc_il_4_noilp": {"layers": [[96, 80], [192, 160]], "frames": 4,
                       "qp": 30, "gop_size": 4, "me_range": 8,
                       "svc_inter_layer_p": False},
    # tests/test_svc_residual_pred.py: same-resolution CGS pair
    "svc_respred_4": {"layers": [[176, 144], [176, 144]], "frames": 4,
                      "qp": 30, "gop_size": 4, "me_range": 8},
    # tests/test_svc_quality.py: quality_id 1 refinement
    "svc_quality_4": {"layers": [[176, 144]], "frames": 4, "qp": 32,
                      "gop_size": 4, "me_range": 8, "quality_layers": 2,
                      "quality_qp_delta": 6},
}
PCM = "pcm_64x48"
QP = 30
ME_RANGE = 12
MAX_BYTES = 1 << 20


def _decode_and_write(name: str, stream: bytes, meta: dict) -> dict:
    """Decode ``stream`` with ``hartallo_tpu``, record each frame's MD5 and
    write the pair of files."""
    md5, _ = _md5s(stream)
    if len(md5) != meta["frames"]:
        raise SystemExit(f"{name}: decoded {len(md5)} of {meta['frames']} "
                         "frames")
    return _write(name, stream, {**meta, "bytes": len(stream),
                                 "frame_md5": md5})


def _md5s(stream: bytes, **window):
    from hartallo_tpu.api import Codec, CodecConfig
    from hartallo_tpu.util.checks import plane_md5
    out = Codec(CodecConfig(**window)).decode_annexb(stream, tolerant=False)
    return [plane_md5(r.frame) for r in out], [r.dqid for r in out]


def _write(name: str, stream: bytes, meta: dict) -> dict:
    if len(stream) > MAX_BYTES:
        raise SystemExit(f"{name}: stream of {len(stream)} bytes is over "
                         f"{MAX_BYTES}")
    (OUT / f"{name}.264").write_bytes(stream)
    (OUT / f"{name}.json").write_text(json.dumps(meta, indent=1) + "\n")
    return meta


def make_svc(name: str) -> dict:
    """An SVC fixture, encoded and decoded by ``hartallo_tpu``: the MD5
    and DQId of every output picture, and the MD5s of the decodes with
    ``dqid_max=0`` and with ``tid_max=0``."""
    sys.path.insert(0, str(REPO / "tests"))
    import _torch_port
    from hartallo_tpu.api import Codec, CodecConfig

    meta = {**SVC[name], "deblock": True,
            "clip": "tests/_torch_port.layer_clips"}
    stream = _torch_port.svc_encode(
        Codec(_torch_port.svc_config(CodecConfig, meta)), meta)
    md5, dqid = _md5s(stream)
    base, _ = _md5s(stream, dqid_max=0)
    t0, _ = _md5s(stream, tid_max=0)
    return _write(name, stream, {
        **meta, "bytes": len(stream), "outputs": len(md5),
        "frame_md5": md5, "frame_dqid": dqid, "dqid_max0_md5": base,
        "tid_max0_md5": t0})


def make_pcm() -> dict:
    """The all-I_PCM IDR picture of tests/test_pcm.py: the SPS and PPS of
    a 64x48 encode, then one slice whose every MB is I_PCM with seeded
    samples, deblocking off."""
    import numpy as np
    from hartallo_tpu.api import Codec, CodecConfig
    from hartallo_tpu.bitio import (BitReader, BitWriter, find_nal_units,
                                    insert_emulation_prevention,
                                    strip_emulation_prevention)
    from hartallo_tpu.decode import nal as N
    from hartallo_tpu.decode.params import PPS, SPS
    from hartallo_tpu.decode.sliceheader import (SliceHeader,
                                                 write_slice_header)
    W, H = 64, 48
    r0 = Codec(CodecConfig(width=W, height=H, qp=30, gop_size=1)).encode(
        np.zeros(W * H * 3 // 2, np.uint8), W, H)
    full = r0.headers + r0.data
    stream = b""
    for s, e in find_nal_units(full):
        r = BitReader(strip_emulation_prevention(full[s:e]))
        h = N.parse_nal_header(r)
        if h.type == N.NAL_SPS:
            sps = SPS.parse(r)
        elif h.type == N.NAL_PPS:
            pps = PPS.parse(r)
        else:
            continue
        stream += b"\x00\x00\x00\x01" + full[s:e]
    rng = np.random.default_rng(9)
    Y = rng.integers(0, 256, (H, W)).astype(np.uint8)
    U = rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8)
    V = rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8)
    sh = SliceHeader(first_mb_in_slice=0, slice_type=7,
                     pic_parameter_set_id=pps.pic_parameter_set_id,
                     frame_num=0, idr_pic_id=1,
                     disable_deblocking_filter_idc=1)
    w = BitWriter()
    N.write_nal_header(w, 3, N.NAL_SLICE_IDR)
    write_slice_header(w, sh, sps, pps, nal_ref_idc=3, is_idr=True)
    for my in range(sps.pic_height_in_mbs):
        for mx in range(sps.pic_width_in_mbs):
            w.ue(25)                         # mb_type = I_PCM (I slices)
            w.align_zero()
            for pl, s in ((Y, 16), (U, 8), (V, 8)):
                for v in pl[my * s:(my + 1) * s, mx * s:(mx + 1) * s].ravel():
                    w.u(int(v), 8)
    w.write_rbsp_trailing_bits()
    stream += b"\x00\x00\x00\x01" + insert_emulation_prevention(
        w.getvalue())
    return _decode_and_write(PCM, stream, {
        "width": W, "height": H, "frames": 1, "pcm_seed": 9,
        "clip": "tests/test_pcm.py"})


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
    if name in SVC:
        return make_svc(name)
    if name == PCM:
        return make_pcm()
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
    for name in names or [*FIXTURES, *REWRITES, *SVC, PCM]:
        meta = make(name)
        print(name, meta["bytes"], "bytes", meta.get("outputs",
                                                     meta["frames"]),
              "pictures", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
