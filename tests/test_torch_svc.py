"""SVC streams through the PyTorch port, against the JAX package's output.

The fixtures (tools/make_port_fixtures.py, ``SVC``) are small versions of
the configurations of tests/test_svc.py (two dyadic layers),
test_svc_ess.py (ratio 1.5), test_svc_inter_layer.py (qp 30, base-mode
EP pictures on and off), test_svc_residual_pred.py (a same-resolution
pair) and test_svc_quality.py (a quality_id 1 refinement layer), each
encoded and decoded by ``hartallo_tpu``.

- The port's CPU decode gives every output picture's recorded MD5 and
  DQId, and so do its ``dqid_max=0`` and ``tid_max=0`` decodes.
- The port's CPU encode of the same clips gives the fixture's bytes.
- With base-mode EP pictures off, the enhancement layer's P pictures take
  the batched route and predict from the I_BL IDR picture that the
  general route decoded: the two routes share the layer's ring.
- On a GPU: the same decodes through ``Codec``'s default device, the
  GOP kernel launched once per kernel picture and every general-route
  deblock equal to the kernel's plain twin; an encode on the card gives
  the fixture's bytes.

Tolerance: exact equality of bytes and MD5s.
"""
import numpy as np
import pytest

from _torch_port import (cuda_device, load_fixture,  # noqa: F401
                         one_torch_thread, svc_config, svc_encode,
                         twin_checked_deblock)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL_SVC = ["svc_2l_3", "svc_ess_4", "svc_il_4", "svc_il_4_noilp",
             "svc_respred_4", "svc_quality_4"]


def md5s(results):
    from hartallo_tpu.util.checks import plane_md5
    return [plane_md5(r.frame) for r in results]


def port_decode(stream, device="cpu", **window):
    from hartallo_tpu_torch.api import Codec, CodecConfig
    codec = Codec(CodecConfig(**window), device=device)
    return codec.decode_annexb(stream, tolerant=False), codec.decoder.stats


def check_decode(name, device="cpu"):
    stream, meta = load_fixture(name)
    out, stats = port_decode(stream, device)
    assert md5s(out) == meta["frame_md5"]
    assert [r.dqid for r in out] == meta["frame_dqid"]
    assert sum(stats.values()) == meta["outputs"]
    assert stats["general_pictures"] > 0 and stats["scan_pictures"] == 0
    return stats


def check_windows(name, device="cpu"):
    stream, meta = load_fixture(name)
    out, _ = port_decode(stream, device, dqid_max=0)
    assert md5s(out) == meta["dqid_max0_md5"]
    assert {r.dqid for r in out} == {0}
    out, _ = port_decode(stream, device, tid_max=0)
    assert md5s(out) == meta["tid_max0_md5"]


def port_encode(name, device="cpu"):
    from hartallo_tpu_torch.api import Codec, CodecConfig
    meta = load_fixture(name)[1]
    return svc_encode(Codec(svc_config(CodecConfig, meta), device=device),
                      meta)


@pytest.mark.parametrize("name", SMALL_SVC)
def test_svc_fixture_decodes_to_recorded_md5(name):
    check_decode(name)


@pytest.mark.parametrize("name", SMALL_SVC)
def test_svc_fixture_windows_decode_to_recorded_md5(name):
    check_windows(name)


@pytest.mark.parametrize("name", SMALL_SVC)
def test_svc_fixture_encodes_byte_for_byte(name):
    assert port_encode(name) == load_fixture(name)[0]


def test_routes_share_the_ring_without_base_mode():
    """svc_il_4_noilp: the enhancement IDR picture is all I_BL (general
    route); its three within-layer P pictures and the four base pictures
    take the kernel route, the first reading the I_BL picture from the
    ring slot the general route filled."""
    _, stats = port_decode(load_fixture("svc_il_4_noilp")[0])
    assert stats == {"kernel_pictures": 7, "scan_pictures": 0,
                     "general_pictures": 1}


def test_quality_refinement_refines():
    """svc_quality_4: the quality_id 1 pictures are closer to the source
    than the base pictures, as tests/test_svc_quality.py holds."""
    from _torch_port import layer_clips
    stream, meta = load_fixture("svc_quality_4")
    out, _ = port_decode(stream)
    clip = layer_clips(meta)[0]

    def psnr(a, b):
        mse = np.mean((np.asarray(a, float) - np.asarray(b, float)) ** 2)
        return 10 * np.log10(255 * 255 / max(mse, 1e-9))
    q0 = [r.frame for r in out if r.dqid == 0]
    q1 = [r.frame for r in out if r.dqid == 1]
    assert len(q0) == len(q1) == meta["frames"]
    for i, (a, b) in enumerate(zip(q0, q1)):
        assert psnr(b, clip[i]) > psnr(a, clip[i]) + 0.5, i


@pytest.mark.cuda
@pytest.mark.parametrize("name", SMALL_SVC)
def test_cuda_svc_decode_matches_recorded_md5(cuda_device, name,
                                              twin_checked_deblock):
    from hartallo_tpu_torch.decode import d_gop_fast as G
    G.LAUNCHES = 0
    stats = check_decode(name, cuda_device)
    assert G.LAUNCHES == stats["kernel_pictures"]
    assert len(twin_checked_deblock) == stats["general_pictures"]
    check_windows(name, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["svc_il_4", "svc_quality_4"])
def test_cuda_svc_encode_byte_for_byte(cuda_device, name):
    assert port_encode(name, cuda_device) == load_fixture(name)[0]
