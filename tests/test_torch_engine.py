"""The port's engine layer (``hartallo_tpu_torch/engine.py``), API surface
and command line, against the JAX package's.

The three tests of ``tests/test_engine.py`` on the port with
``device="cpu"``: the plugin registry, ``add_layer`` validation, and a
runtime ``set_option("qp", ...)`` between pictures, whose stream is the
JAX engine's byte for byte and decodes with the port.  Then
``api.Engine`` / ``api.Parser`` and the package exports, and
``python -m hartallo_tpu_torch.cli`` re-encoding and decoding a fixture on
the CPU.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from _torch_port import load_fixture, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_registry_semantics():
    from hartallo_tpu_torch import engine as E
    avc = E.plugin_find(E.CODEC_TYPE_H264_AVC)
    svc = E.plugin_find(E.CODEC_TYPE_H264_SVC)
    assert avc.create is not None and svc.type == "h264-svc"
    with pytest.raises(E.EngineError) as ei:
        E.plugin_find("vp9")
    assert ei.value.code == "HL_ERROR_NOT_FOUND"
    p = E.CodecPlugin(type="test", description="t",
                      create=lambda c, device: None)
    E.plugin_register(p)
    assert E.plugin_find("test") is p
    E.plugin_unregister(p)
    with pytest.raises(E.EngineError):
        E.plugin_find("test")
    with pytest.raises(E.EngineError) as ei:
        E.plugin_unregister(p)
    assert ei.value.code == "HL_ERROR_NOT_FOUND"
    with pytest.raises(E.EngineError) as ei:
        E.plugin_register(None)
    assert ei.value.code == "HL_ERROR_INVALID_PARAMETER"


def test_registry_bounds_and_device():
    """The table holds MAX_PLUGINS entries (HL_ERROR_OUTOFBOUND beyond),
    and a created codec runs on the device codec_create was given."""
    from hartallo_tpu import engine as JE
    from hartallo_tpu_torch import engine as E
    from hartallo_tpu_torch.api import Codec
    assert (E.MAX_PLUGINS, E.MAX_LAYERS, E._RUNTIME_OPTIONS) == \
        (JE.MAX_PLUGINS, JE.MAX_LAYERS, JE._RUNTIME_OPTIONS)
    extra = [E.CodecPlugin(type=f"t{i}", description="", create=Codec)
             for i in range(E.MAX_PLUGINS)]
    try:
        with pytest.raises(E.EngineError) as ei:
            for p in extra:
                E.plugin_register(p)
        assert ei.value.code == "HL_ERROR_OUTOFBOUND"
    finally:
        for p in extra:
            if p in E._plugins:
                E.plugin_unregister(p)
    c = E.codec_create(E.CODEC_TYPE_H264_AVC, device="cpu")
    assert c.codec.device == "cpu" and isinstance(c.codec, Codec)
    assert E.codec_create(E.CODEC_TYPE_H264_SVC).device == "cuda"


def test_add_layer_validation():
    from hartallo_tpu_torch import engine as E
    c = E.codec_create(E.CODEC_TYPE_H264_SVC, device="cpu")
    c.add_layer(96, 64)
    with pytest.raises(E.EngineError):       # not increasing
        c.add_layer(96, 64)
    with pytest.raises(E.EngineError):       # ratio 3 under strict
        c.add_layer(288, 192, strict_dyadic=True)
    c.add_layer(144, 96)                     # ESS ratio allowed
    c.clear_layers()
    assert c.config.layers == []
    for i in range(E.MAX_LAYERS):
        c.add_layer(16 * (i + 1), 16 * (i + 1))
    with pytest.raises(E.EngineError) as ei:
        c.add_layer(999, 999)
    assert ei.value.code == "HL_ERROR_OUTOFCAPACITY"


def test_set_option_runtime_qp():
    """qp set between pictures takes effect on the next picture; the
    stream is the JAX engine's (``engine_qp_96x64_3``, written by
    ``tools/make_port_fixtures.py``), byte for byte."""
    import bench
    from hartallo_tpu_torch import engine as E
    from hartallo_tpu_torch.api import Codec, CodecConfig
    from hartallo_tpu_torch.util.checks import plane_md5, psnr
    from _torch_port import RUNTIME_QP_CLIP, runtime_qp_stream
    want, meta = load_fixture("engine_qp_96x64_3")
    clip = bench.make_clip(*RUNTIME_QP_CLIP)
    assert runtime_qp_stream(E, CodecConfig, clip, device="cpu") == want
    out = Codec(CodecConfig(), device="cpu").decode_annexb(want,
                                                           tolerant=False)
    assert [plane_md5(r.frame) for r in out] == meta["frame_md5"]
    # qp 24 frames must be clearly better than the qp 40 frame
    assert psnr(out[1].frame, clip[1]) > psnr(out[0].frame, clip[0]) + 3
    c = E.codec_create(E.CODEC_TYPE_H264_AVC, device="cpu")
    with pytest.raises(E.EngineError) as ei:
        c.set_option("entropy", "cabac")
    assert ei.value.code == "HL_ERROR_NOT_IMPLEMENTED"


def test_set_option_reaches_svc_layers():
    """set_option rebinds the live per-layer encoders and the quality
    encoder, as the JAX engine does."""
    from hartallo_tpu_torch import engine as E
    from hartallo_tpu_torch.api import CodecConfig
    c = E.codec_create(E.CODEC_TYPE_H264_SVC,
                       CodecConfig(qp=30, quality_layers=2,
                                   quality_qp_delta=6), device="cpu")
    c.add_layer(64, 48)
    c.encode(np.full(64 * 48 * 3 // 2, 128, np.uint8), 64, 48)
    enc = c.codec.encoder
    assert enc.qenc is not None and enc.qenc.cfg.qp == 24
    c.set_option("me_range", 4)
    c.set_option("qp", 28)
    assert [sub.cfg.me_range for sub in enc.layers] == [4]
    assert [sub.cfg.qp for sub in enc.layers] == [28]
    assert (enc.qenc.cfg.me_range, enc.qenc.cfg.qp) == (4, 22)


def test_api_surface_matches_jax():
    import hartallo_tpu
    import hartallo_tpu_torch
    from hartallo_tpu_torch.api import Engine, Parser
    names = ("Engine", "CodecConfig", "Codec", "Parser", "DecodeResult",
             "EncodeResult")
    assert all(hasattr(hartallo_tpu_torch, n) for n in names)
    assert hartallo_tpu_torch.__version__ == hartallo_tpu.__version__
    Engine.init()
    assert Engine.initialized()
    stream, _ = load_fixture("qcif_6_slices3")
    assert Parser.find_nal_units(stream) == \
        hartallo_tpu.Parser.find_nal_units(stream)


def _cli(*args, cwd=REPO):
    # one torch thread, as in this module: the CLI's eager ops on the CPU
    # beside other test workers
    proc = subprocess.run([sys.executable, "-m", "hartallo_tpu_torch.cli",
                           *args, "--device", "cpu"], cwd=cwd,
                          env={**os.environ, "OMP_NUM_THREADS": "1"},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1]), proc.stderr


def test_cli_encode_and_decode(tmp_path):
    """The port's CLI re-encodes the qcif_6 clip to the fixture's bytes and
    decodes the fixture to its MD5s, on the CPU."""
    import bench
    from hartallo_tpu_torch.util.checks import frame_md5, plane_md5
    stream, meta = load_fixture("qcif_6")
    W, H, NF = meta["width"], meta["height"], meta["frames"]
    yuv = tmp_path / "in.yuv"
    yuv.write_bytes(b"".join(f.tobytes() for f in bench.make_clip(W, H, NF)))
    out, _ = _cli("encode", str(yuv), str(W), str(H),
                  str(tmp_path / "out.264"), "--qp", "30", "--gop",
                  str(NF), "--me-range", "12")
    assert out["op"] == "encode" and out["frames"] == NF
    assert (tmp_path / "out.264").read_bytes() == stream
    out, err = _cli("decode", str(tmp_path / "out.264"),
                    str(tmp_path / "dec.yuv"), "--md5")
    assert out["frames"] == NF and out["device"] == "cpu"
    dec = np.frombuffer((tmp_path / "dec.yuv").read_bytes(), np.uint8) \
        .reshape(NF, -1)
    assert [plane_md5(f) for f in dec] == meta["frame_md5"]
    assert err.count("MD5") == NF and str(frame_md5(dec[0], W, H)) in err
