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
variants.  Such rewrites are stored too: ``qcif_6_wp``, ``qcif_6`` with
explicit weighted prediction on every P slice
(``tests/_torch_port.weighted_rewrite``), a stream whose P pictures the
GOP kernel refuses, so ``chip_smoke.py`` keeps the GOP scan measured on
the card, and ``720p_8_wp`` and ``1080p_8_wp``, the same rewrite of
``720p_8`` and ``1080p_8``, which take the GOP scan at full width; and
``qcif_6_sl``, ``qcif_6`` with non-flat 4x4 scaling lists
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

The row-sharded fixtures of ``parallel/shard.py`` (``SHARD``) are coded
for a sharded decode (GOPs of 4 pictures, two temporal layers, slices of
whole MB rows, no deblocking across slice edges), decoded by the JAX
decoder and by its ``decode_gops_grouped`` with 2 groups on virtual CPU
devices, which must give the same frames (the JSON records how long that
took): ``shard_1080p_8``, ``bench.make_clip(1920, 1080, 8)`` in 4 slices
of 17 MB rows, ``me_range`` 12, on 4 devices; ``shard_96x64_8``, the
noise clip of ``__graft_entry__`` at 96x64 in 4 slices of one MB row, on
8 devices (bands of one MB row).  ``shard_p_1080p.json`` holds the
MD5 of each of the eight outputs of the JAX package's
``p_encode_step_sharded`` on 4 virtual CPU devices for frame 1 of
``bench.make_clip(1920, 1080, 2)`` against frame 0 (both padded to 1088
coded rows as the encoder pads them), qp 30, the encoder's lambda at qp
30, ``rng`` 12.  ``shard_slices_96x64_8`` is ``shard_96x64_8``'s clip in
slices that start mid-row inside a band (``SHARD_SLICES``: 2 bands of 2
MB rows, each cut into slices of 9 and 3 MBs, laid out by a subclass of
the JAX encoder whose slices are MB ranges), decoded on 4 devices in 2
groups of 2 bands with the JAX step compiled by ``jax.jit``; its JSON
records whether that decode equals the decoder's frames and, where it
does not, the first band, MB and both values.

``engine_qp_96x64_3`` is the stream of ``tests/test_engine.py``'s
runtime-qp test (``tests/_torch_port.runtime_qp_stream``): the JAX
engine's ``ManagedCodec`` encoding 3 pictures with ``set_option("qp",
24)`` after the first.
"""
from __future__ import annotations

import hashlib
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
            "qcif_6_sl": ("qcif_6", "scaling_list_rewrite"),
            "720p_8_wp": ("720p_8", "weighted_rewrite"),
            "1080p_8_wp": ("1080p_8", "weighted_rewrite")}
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
# name -> (clip, CodecConfig settings, devices of the JAX grouped decode)
# of a stream cut into row bands
SHARD = {
    "shard_1080p_8": ("bench.make_clip", {
        "width": 1920, "height": 1080, "frames": 8, "qp": 30,
        "gop_size": 4, "slices": 4, "deblock": True,
        "deblock_slice_edges": False, "temporal_layers": 2,
        "me_range": 12}, 4),
    # __graft_entry__'s sharded-decode stream (one slice per MB row, fresh
    # noise in every picture, so the P pictures hold intra MBs) at 4 MB
    # rows and 8 pictures: 4 bands of one MB row on each of 2 groups
    "shard_96x64_8": ("__graft_entry__", {
        "width": 96, "height": 64, "frames": 8, "qp": 30, "gop_size": 4,
        "slices": 4, "deblock": True, "deblock_slice_edges": False,
        "temporal_layers": 2, "me_range": 4}, 8),
    # shard_96x64_8's clip in slices that start mid-row inside a band: 2
    # bands of 2 MB rows on each of 2 groups
    "shard_slices_96x64_8": ("__graft_entry__", {
        "width": 96, "height": 64, "frames": 8, "qp": 30, "gop_size": 4,
        "deblock": True, "deblock_slice_edges": False,
        "temporal_layers": 2, "me_range": 4}, 4),
}
# name -> (bands, MBs per slice): slices restart at every band's first MB
SHARD_SLICES = {"shard_slices_96x64_8": (2, 9)}
SHARD_P = "shard_p_1080p"
ENGINE_QP = "engine_qp_96x64_3"
SHARD_DEVICES = 4                # the P step's virtual CPU devices
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


def graft_clip(W: int, H: int, NF: int):
    """The clip of ``__graft_entry__._dryrun_sharded_decode_and_gop_
    pipeline``: seeded noise with a moving bright square, flat chroma."""
    import numpy as np
    rng = np.random.default_rng(3)
    clip = []
    for t in range(NF):
        Y = rng.integers(0, 256, (H, W)).astype(np.uint8)
        Y[8:40, 8 + 4 * t:40 + 4 * t] = 200
        U = np.full((H // 2, W // 2), 100, np.uint8)
        V = np.full((H // 2, W // 2), 150, np.uint8)
        clip.append(np.concatenate([Y.ravel(), U.ravel(), V.ravel()]))
    return clip


def band_slice_encoder(cfg, bands: int, slice_mbs: int):
    """A ``hartallo_tpu`` encoder whose slices are runs of ``slice_mbs``
    MBs in raster order that restart at the first MB of each of ``bands``
    equal row bands, so that slices start mid-row inside a band and every
    band starts a slice."""
    import numpy as np
    from hartallo_tpu.decode.intra_recon import (availability_masks,
                                                 availability_tl,
                                                 availability_tr)
    from hartallo_tpu.encode.encoder import Encoder

    class BandSliceEncoder(Encoder):
        def _slice_layout(self, gw: int, gh: int):
            n = gw * gh // bands
            ranges = [np.arange(b * n + s, min(b * n + s + slice_mbs,
                                               (b + 1) * n), dtype=np.int32)
                      for b in range(bands) for s in range(0, n, slice_mbs)]
            slice_id = np.zeros(gw * gh, np.int32)
            for sid, mbs in enumerate(ranges):
                slice_id[mbs] = sid
            slice_id = slice_id.reshape(gh, gw)
            none = np.zeros((gh, gw), bool)
            return (ranges, slice_id,
                    *availability_masks(slice_id, False, none),
                    availability_tr(slice_id, False, none),
                    availability_tl(slice_id, False, none))

    return BandSliceEncoder(cfg)


def jax_grouped_decode(stream: bytes, devices: int):
    """``hartallo_tpu``'s ``decode_gops_grouped`` with 2 groups on
    ``devices`` virtual CPU devices, its per-picture step compiled by
    ``jax.jit`` (called as it is, its ``shard_map`` runs op by op)."""
    import jax
    # imported before the step is traced: their module-level arrays must
    # not be created under the trace
    import hartallo_tpu.decode.d_gop  # noqa: F401
    import hartallo_tpu.decode.intra_recon  # noqa: F401
    import hartallo_tpu.ops.deblock  # noqa: F401
    import hartallo_tpu.ops.wide  # noqa: F401
    import hartallo_tpu.parallel.shard as JS
    step = JS.decode_frame_step_sharded
    JS.decode_frame_step_sharded = jax.jit(
        step, static_argnums=(0,),
        static_argnames=("gw", "gh", "chroma_qp_off", "has_intra", "S"))
    try:
        return JS.decode_gops_grouped(JS.make_mesh(devices), stream,
                                      groups=2)
    finally:
        JS.decode_frame_step_sharded = step


def first_difference(got, want, W: int, H: int, bands: int):
    """Where two packed I420 frames first differ: the plane, the band of
    ``bands`` MB-row bands, the MB (column, row), the sample and both
    values; None when they are equal."""
    import numpy as np
    got, want = np.asarray(got).ravel(), np.asarray(want).ravel()
    diff = np.nonzero(got != want)[0]
    if not len(diff):
        return None
    i = int(diff[0])
    for plane, w, h, mb, off in (("Y", W, H, 16, 0),
                                 ("U", W // 2, H // 2, 8, W * H),
                                 ("V", W // 2, H // 2, 8, W * H * 5 // 4)):
        if off <= i < off + w * h:
            y, x = divmod(i - off, w)
            return {"plane": plane, "band": y // (h // bands),
                    "mb": [x // mb, y // mb], "sample": [x, y],
                    "got": int(got[i]), "want": int(want[i]),
                    "samples_differing": int(len(diff))}


def make_shard(name: str) -> dict:
    """A stream for the row-sharded decode, encoded and decoded by
    ``hartallo_tpu``; its ``decode_gops_grouped`` with 2 groups on the
    fixture's number of virtual CPU devices must give the same frames
    (for ``SHARD_SLICES``, the JSON records where they differ)."""
    import time

    import numpy as np
    from bench import make_clip
    from hartallo_tpu.api import Codec, CodecConfig
    from hartallo_tpu.parallel.shard import decode_gops_grouped, make_mesh
    from hartallo_tpu.util.checks import plane_md5

    clip, cfg, devices = SHARD[name]
    W, H, NF = cfg["width"], cfg["height"], cfg["frames"]
    frames = (make_clip if clip == "bench.make_clip" else graft_clip)(
        W, H, NF)
    config = CodecConfig(**{k: v for k, v in cfg.items() if k != "frames"})
    if name in SHARD_SLICES:
        bands, slice_mbs = SHARD_SLICES[name]
        enc = band_slice_encoder(config, bands, slice_mbs)
        stream = b"".join(r.headers + r.data
                          for r in (enc.encode_frame(f, W, H)
                                    for f in frames))
        cfg = {**cfg, "bands": bands, "slice_mbs": slice_mbs}
    else:
        enc = Codec(config)
        stream = b"".join(r.headers + r.data
                          for r in (enc.encode(f, W, H) for f in frames))
    meta = _decode_and_write(name, stream, {**cfg, "clip": clip})
    t0 = time.perf_counter()
    if name in SHARD_SLICES:
        grouped = jax_grouped_decode(stream, devices)
    else:
        grouped = decode_gops_grouped(make_mesh(devices), stream, groups=2)
    dt = time.perf_counter() - t0
    md5 = [plane_md5(np.asarray(f)) for f in grouped]
    record = {"devices": devices, "groups": 2,
              "equal": md5 == meta["frame_md5"],
              "seconds_on_cpu": round(dt, 1)}
    if name in SHARD_SLICES:
        plain = Codec(CodecConfig()).decode_annexb(stream, tolerant=False)
        record["step"] = "jax.jit"
        record["differences"] = [
            {"frame": i, **d} for i, (g, p) in enumerate(zip(grouped, plain))
            if (d := first_difference(g, p.frame, W, H,
                                      devices // 2)) is not None]
    elif not record["equal"]:
        raise SystemExit(f"{name}: decode_gops_grouped differs from the "
                         "decoder")
    return _write(name, stream, {**meta, "jax_decode_gops_grouped": record})


def make_engine_qp() -> dict:
    """The runtime-qp stream of ``tests/test_engine.py`` from the JAX
    engine, with each frame's MD5 from the JAX decoder."""
    sys.path.insert(0, str(REPO / "tests"))
    import _torch_port
    import bench
    from hartallo_tpu import engine
    from hartallo_tpu.api import CodecConfig

    W, H, NF = _torch_port.RUNTIME_QP_CLIP
    stream = _torch_port.runtime_qp_stream(engine, CodecConfig,
                                           bench.make_clip(W, H, NF))
    return _decode_and_write(ENGINE_QP, stream, {
        "width": W, "height": H, "frames": NF, "clip": "bench.make_clip",
        "codec": "engine.codec_create(CODEC_TYPE_H264_AVC, ...)",
        **_torch_port.RUNTIME_QP_CONFIG, "set_option": {"after": 1,
                                                        "qp": 24}})


def shard_p_inputs(pack_src, make_clip):
    """(srcY, srcU, srcV, refY, refU, refV) int32 planes of the sharded P
    step: frames 1 and 0 of ``make_clip(1920, 1080, 2)`` through the
    encoder's ``pack_src`` (1088 coded rows, edge-replicated)."""
    import numpy as np
    gw, gh = 120, 68
    H, W = gh * 16, gw * 16
    planes = []
    for f in make_clip(1920, 1080, 2)[::-1]:
        buf = pack_src(f, 1920, 1080, gw, gh).astype(np.int32)
        uv = buf[H:].reshape(H // 2, 2, W // 2)
        planes += [buf[:H], uv[:, 0], uv[:, 1]]
    return tuple(planes)


def int32_md5(a) -> str:
    """MD5 of an array's values as C-ordered little-endian int32."""
    import numpy as np
    return hashlib.md5(np.ascontiguousarray(np.asarray(a), "<i4")
                       .tobytes()).hexdigest()


SHARD_P_OUTPUTS = ("wq", "dcq", "acq", "mv44", "choice", "recY", "recU",
                   "recV")


def make_shard_p() -> dict:
    """The MD5s of the eight outputs of ``hartallo_tpu``'s sharded P step
    at 1080p on ``SHARD_DEVICES`` virtual CPU devices."""
    import numpy as np
    from bench import make_clip
    from hartallo_tpu.encode.e_device import pack_src
    from hartallo_tpu.parallel.shard import make_mesh, p_encode_step_sharded

    qp_val, rng = 30, 12
    lam = np.float32(np.sqrt(0.85 * 2.0 ** ((qp_val - 12) / 3.0)))
    planes = shard_p_inputs(pack_src, make_clip)
    out = p_encode_step_sharded(
        make_mesh(SHARD_DEVICES), *planes,
        np.full((68, 120), qp_val, np.int32), float(lam), gw=120, gh=68,
        rng=rng)
    meta = {"width": 1920, "height": 1080, "gw": 120, "gh": 68,
            "src": "frame 1 of bench.make_clip(1920, 1080, 2)",
            "ref": "frame 0", "padding": "encode/e_device.pack_src",
            "qp": qp_val, "lam": float(lam), "rng": rng,
            "devices": SHARD_DEVICES, "md5": "int32 values, C order",
            "outputs": {k: {"shape": list(np.asarray(v).shape),
                            "md5": int32_md5(v)}
                        for k, v in zip(SHARD_P_OUTPUTS, out)}}
    text = json.dumps(meta, indent=1) + "\n"
    (OUT / f"{SHARD_P}.json").write_text(text)
    return {"bytes": len(text), "frames": 1}


def make(name: str) -> dict:
    from bench import make_clip
    from hartallo_tpu.api import Codec, CodecConfig

    if name in SHARD:
        return make_shard(name)
    if name == SHARD_P:
        return make_shard_p()
    if name == ENGINE_QP:
        return make_engine_qp()
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
    jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(REPO))
    OUT.mkdir(parents=True, exist_ok=True)
    for name in names or [*FIXTURES, *REWRITES, *SVC, PCM, *SHARD,
                          SHARD_P, ENGINE_QP]:
        meta = make(name)
        print(name, meta["bytes"], "bytes", meta.get("outputs",
                                                     meta["frames"]),
              "pictures", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
