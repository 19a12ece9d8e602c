"""The general decode path of the PyTorch port against the JAX package.

- The modules the path runs, live against the JAX functions on the same
  seeded numpy inputs: ``svc/upsample.upsample_plane`` (dyadic, ratio
  1.5, luma and chroma), ``decode/intra_recon.compute_residuals`` with
  flat and with non-flat scaling lists, and
  ``decode/d_device.decode_frame_pre`` at 4x3 MBs with inter, I_BL, I_PCM
  and residual-prediction MBs, with and without scaling lists.
- Whole streams: the all-I_PCM picture of tests/test_pcm.py
  (``pcm_64x48``, its output the raw samples) and ``qcif_6`` with
  non-flat scaling lists (``qcif_6_sl``, the rewrite of
  tests/test_scaling_lists.py) decode to the JAX package's MD5s, every
  picture through the general path.
- Tolerant mode: a stream with an MVC slice extension injected decodes to
  the same frames in both packages (the NAL is skipped), and raises
  NotImplementedError in both when the caller is not tolerant.
- On a GPU: ``qcif_6_sl`` on ``Codec``'s default device, each picture's
  deblock through the CUDA kernel and equal to the plain twin.

Tolerance: exact equality (integer codec).
"""
import numpy as np
import pytest
import torch

from _torch_port import (cuda_device, load_fixture,  # noqa: F401
                         twin_checked_deblock)

GW, GH = 4, 3
MVC_NAL = b"\x00\x00\x00\x01\x14\x40\x11\x22\x80"


def t(a, dtype=torch.int32):
    return torch.as_tensor(np.asarray(a)).to(dtype)


@pytest.mark.parametrize("oh,ow,chroma", [(80, 96, False), (80, 96, True),
                                          (60, 72, False), (120, 144, True)])
def test_upsample_plane_equals_jax(oh, ow, chroma):
    import jax.numpy as jnp
    from hartallo_tpu.svc.upsample import upsample_plane as jax_up
    from hartallo_tpu_torch.svc.upsample import upsample_plane
    base = np.random.default_rng(3).integers(0, 256, (40, 48)).astype(
        np.int32)
    want = np.asarray(jax_up(jnp.asarray(base), oh, ow, chroma))
    got = upsample_plane(t(base, torch.uint8), oh, ow, chroma)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def residual_inputs(seed, gw=GW, gh=GH):
    """Seeded coefficient levels, QPs, MB kinds and scaling lists."""
    rng = np.random.default_rng(seed)
    kind = rng.choice([0, 1, 2, 4, 7, 8, 9], (gh, gw)).astype(np.int32)
    sparse = rng.random((gh, gw, 16, 4, 4)) < 0.3
    return dict(
        luma_ac=(rng.integers(-40, 41, (gh, gw, 16, 4, 4)) * sparse)
        .astype(np.int32),
        luma_dc=rng.integers(-60, 61, (gh, gw, 4, 4)).astype(np.int32),
        chroma_ac=rng.integers(-20, 21, (gh, gw, 2, 4, 4, 4)).astype(
            np.int32),
        chroma_dc=rng.integers(-40, 41, (gh, gw, 2, 2, 2)).astype(np.int32),
        qp=rng.integers(0, 52, (gh, gw)).astype(np.int32),
        kind=kind,
        weight4x4=rng.integers(4, 64, (2, 3, 4, 4)).astype(np.int32))


@pytest.mark.parametrize("weights", [False, True])
def test_compute_residuals_equals_jax(weights):
    import jax.numpy as jnp
    from hartallo_tpu.decode.intra_recon import compute_residuals as jax_cr
    from hartallo_tpu_torch.decode.intra_recon import compute_residuals
    x = residual_inputs(5)
    is_i16 = x["kind"] == 1
    inter = (x["kind"] >= 3) & (x["kind"] != 8)
    for off in (0, -3):
        want = jax_cr(*(jnp.asarray(x[k]) for k in (
            "luma_ac", "luma_dc", "chroma_ac", "chroma_dc", "qp")),
            jnp.asarray(is_i16), off,
            weight4x4=jnp.asarray(x["weight4x4"]) if weights else None,
            mb_is_inter=jnp.asarray(inter))
        got = compute_residuals(
            *(t(x[k]) for k in ("luma_ac", "luma_dc", "chroma_ac",
                                "chroma_dc", "qp")),
            t(is_i16, torch.bool), off,
            weight4x4=t(x["weight4x4"]) if weights else None,
            mb_is_inter=t(inter, torch.bool))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def frame_pre_inputs(seed, gw=GW, gh=GH):
    """Every input of ``decode_frame_pre`` as numpy, seeded: two reference
    pictures, MVs over the picture edges, an upsampled base, I_PCM
    samples, a base residual and a residual-prediction mask."""
    rng = np.random.default_rng(seed)
    x = residual_inputs(seed, gw, gh)
    H, W = gh * 16, gw * 16
    pcm = x["kind"] == 2

    def pcm_plane(s):
        p = rng.integers(0, 256, (gh * s, gw * s)).astype(np.int32)
        return p * np.repeat(np.repeat(pcm, s, 0), s, 1)
    return [
        x["luma_ac"], x["luma_dc"], x["chroma_ac"], x["chroma_dc"], x["qp"],
        x["kind"] == 1,
        rng.integers(-48, 49, (gh, gw, 4, 4, 2)).astype(np.int32),
        rng.integers(0, 2, (gh, gw, 4)).astype(np.int32),
        rng.integers(0, 256, (2, H + 64, W + 64)).astype(np.int32),
        rng.integers(0, 256, (2, H // 2 + 64, W // 2 + 64)).astype(np.int32),
        rng.integers(0, 256, (2, H // 2 + 64, W // 2 + 64)).astype(np.int32),
        rng.integers(0, 256, (gh, gw, 16, 16)).astype(np.int32),
        rng.integers(0, 256, (gh, gw, 2, 8, 8)).astype(np.int32),
        x["kind"], pcm_plane(16), pcm_plane(8), pcm_plane(8),
        x["weight4x4"],
        rng.integers(-300, 301, (H, W)).astype(np.int32),
        rng.integers(-300, 301, (2, H // 2, W // 2)).astype(np.int32),
        rng.random((gh, gw)) < 0.5]


@pytest.mark.parametrize("use_weights,has_respred",
                         [(False, True), (True, False)])
def test_decode_frame_pre_equals_jax(use_weights, has_respred):
    import jax.numpy as jnp
    from hartallo_tpu.decode.d_device import decode_frame_pre as jax_pre
    from hartallo_tpu_torch.decode.d_device import decode_frame_pre
    args = frame_pre_inputs(11)
    kw = dict(gw=GW, gh=GH, has_inter=True, has_ibl=True, chroma_qp_off=2,
              use_weights=use_weights, has_respred=has_respred)
    want = jax_pre(*(jnp.asarray(a) for a in args), **kw)
    got = decode_frame_pre(
        *(t(a, torch.bool if a.dtype == bool else torch.int32)
          for a in args), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def port_decode(stream, device="cpu", tolerant=False):
    from hartallo_tpu_torch.api import Codec, CodecConfig
    codec = Codec(CodecConfig(), device=device)
    return codec.decode_annexb(stream, tolerant=tolerant), codec.decoder.stats


def md5s(results):
    from hartallo_tpu.util.checks import plane_md5
    return [plane_md5(r.frame) for r in results]


def test_pcm_fixture_decodes_to_its_samples():
    stream, meta = load_fixture("pcm_64x48")
    out, stats = port_decode(stream)
    assert md5s(out) == meta["frame_md5"]
    assert stats == {"kernel_pictures": 0, "scan_pictures": 0,
                     "general_pictures": 1}
    # I_PCM output is the raw samples (tests/test_pcm.py)
    W, H = meta["width"], meta["height"]
    rng = np.random.default_rng(meta["pcm_seed"])
    exp = np.concatenate([rng.integers(0, 256, s).astype(np.uint8).ravel()
                          for s in ((H, W), (H // 2, W // 2),
                                    (H // 2, W // 2))])
    np.testing.assert_array_equal(out[0].frame, exp)


def test_scaling_list_fixture_is_the_rewrite():
    from _torch_port import scaling_list_rewrite
    assert scaling_list_rewrite(load_fixture("qcif_6")[0]) == \
        load_fixture("qcif_6_sl")[0]


def test_scaling_list_fixture_decodes_to_recorded_md5():
    stream, meta = load_fixture("qcif_6_sl")
    out, stats = port_decode(stream)
    assert md5s(out) == meta["frame_md5"]
    assert stats == {"kernel_pictures": 0, "scan_pictures": 0,
                     "general_pictures": meta["frames"]}
    # the lists change the pictures: the flat stream decodes otherwise
    assert md5s(out) != load_fixture("qcif_6")[1]["frame_md5"]


def test_tolerant_mode_skips_an_mvc_nal_like_jax():
    from hartallo_tpu.api import Codec, CodecConfig
    stream, meta = load_fixture("pcm_64x48")
    # the MVC slice extension right after the parameter sets
    i = stream.index(b"\x00\x00\x00\x01", 4)
    i = stream.index(b"\x00\x00\x00\x01", i + 4)
    bad = stream[:i] + MVC_NAL + stream[i:]
    want = Codec(CodecConfig()).decode_annexb(bad, tolerant=True)
    got, _ = port_decode(bad, tolerant=True)
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(got[0].frame, want[0].frame)
    assert md5s(got) == meta["frame_md5"]
    with pytest.raises(NotImplementedError, match="MVC"):
        Codec(CodecConfig()).decode_annexb(bad, tolerant=False)
    with pytest.raises(NotImplementedError, match="MVC"):
        port_decode(bad, tolerant=False)


@pytest.mark.cuda
def test_cuda_general_path_deblock_matches_twin(cuda_device,
                                                twin_checked_deblock):
    from hartallo_tpu_torch.ops import deblock_fast as D
    stream, meta = load_fixture("qcif_6_sl")
    D.LAUNCHES = 0
    out, stats = port_decode(stream, cuda_device)
    assert md5s(out) == meta["frame_md5"]
    assert stats["general_pictures"] == len(twin_checked_deblock) == \
        D.LAUNCHES == meta["frames"]
