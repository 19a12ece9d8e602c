"""Whole-encode tests of the PyTorch port.

- The port's ``Encoder`` reproduces the JAX package's streams in
  tests/data/port byte for byte: the bench clip through ``encode_frames``
  (one IDR picture, then chunks of P pictures), and the slice, FMO,
  idc-2 and temporal-layer classes through per-frame ``encode``.
- Rate control (JVT-G012 with per-row QPs) encodes the same bytes as the
  JAX encoder on a live 64x48 clip.
- The port's decoder decodes the port's own stream to the recorded MD5s.
- On a GPU, the same QCIF streams come out of an encode on ``cuda``,
  through the deblock kernel once per picture.

Tolerance: exact equality of bytes and MD5s.
"""
import numpy as np
import pytest

from _torch_port import (cuda_device, load_fixture,  # noqa: F401
                         one_torch_thread)
from bench import make_clip

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SETTINGS = ("slices", "num_slice_groups", "slice_group_map_type",
            "deblock_slice_edges", "temporal_layers")
QCIF = ["qcif_8", "qcif_6", "qcif_6_slices3", "qcif_6_fmo1", "qcif_6_idc2",
        "qcif_6_tl2"]


def port_encode(meta, device="cpu"):
    """Encode ``bench.make_clip`` with the fixture's settings, the way
    tools/make_port_fixtures.py made it: ``encode_frames`` for the plain
    bench clip, per-frame ``encode`` for the stream classes."""
    from hartallo_tpu_torch.api import Codec, CodecConfig
    W, H, NF = meta["width"], meta["height"], meta["frames"]
    extra = {k: meta[k] for k in SETTINGS if k in meta}
    codec = Codec(CodecConfig(width=W, height=H, qp=meta["qp"], gop_size=NF,
                              deblock=meta["deblock"],
                              me_range=meta["me_range"], **extra),
                  device=device)
    clip = make_clip(W, H, NF)
    if extra:
        results = [codec.encode(f, W, H) for f in clip]
    else:
        results = codec.encode_frames(clip, W, H)
    assert [r.keyframe for r in results] == [True] + [False] * (NF - 1)
    return b"".join(r.headers + r.data for r in results)


@pytest.fixture(scope="module")
def streams():
    """Port encodes, made once per fixture name."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = port_encode(load_fixture(name)[1])
        return cache[name]
    return get


@pytest.mark.parametrize("name", QCIF)
def test_encoder_reproduces_fixture(streams, name):
    want, _ = load_fixture(name)
    got = streams(name)
    assert len(got) == len(want)
    assert got == want


def test_port_decodes_its_own_stream(streams):
    from hartallo_tpu.util.checks import plane_md5
    from hartallo_tpu_torch.api import Codec, CodecConfig
    _, meta = load_fixture("qcif_8")
    out = Codec(CodecConfig(), device="cpu").decode_annexb(
        streams("qcif_8"), tolerant=False)
    assert [plane_md5(r.frame) for r in out] == meta["frame_md5"]


def test_rate_control_matches_jax_encoder(monkeypatch):
    """Frame-level RC with basic-unit (MB-row) QPs closes its loop through
    the packed bits, so frame QPs and bytes must agree picture by
    picture."""
    from hartallo_tpu import api as J
    from hartallo_tpu.encode.ratecontrol import RateControl as JRC
    from hartallo_tpu_torch import api as P
    from hartallo_tpu_torch.encode.ratecontrol import RateControl as PRC
    W, H, NF = 64, 48, 6
    qps = []

    def recorder(frame_qp):
        def record(self, is_idr):
            qps.append(frame_qp(self, is_idr))
            return qps[-1]
        return record
    # each package's own RateControl (the port's is a copy)
    for cls in (JRC, PRC):
        monkeypatch.setattr(cls, "frame_qp", recorder(cls.frame_qp))

    def cfg(api):
        return api.CodecConfig(width=W, height=H, gop_size=4, deblock=True,
                               me_range=8, rc_bitrate=60000, fps=(1, 30))
    clip = make_clip(W, H, NF)
    want = J.Codec(cfg(J)).encode_frames(clip, W, H)
    want_qps, qps[:] = list(qps), []
    got = P.Codec(cfg(P), device="cpu").encode_frames(clip, W, H)
    assert qps == want_qps and len(set(qps)) > 1, (qps, want_qps)
    assert len(got) == len(want) == NF
    for i, (a, b) in enumerate(zip(got, want)):
        assert (a.headers, a.keyframe) == (b.headers, b.keyframe), i
        assert a.data == b.data, f"picture {i}"
    assert sum(r.keyframe for r in got) == 2                 # two GOPs


@pytest.mark.cuda
@pytest.mark.parametrize("name", QCIF)
def test_cuda_encode_reproduces_fixture(cuda_device, name):
    from hartallo_tpu_torch.ops import deblock_fast
    want, meta = load_fixture(name)
    before = deblock_fast.LAUNCHES
    got = port_encode(meta, cuda_device)
    assert deblock_fast.LAUNCHES - before == meta["frames"]
    assert got == want
    assert np.frombuffer(got, np.uint8).size == meta["bytes"]
