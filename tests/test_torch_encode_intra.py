"""The port's intra encoder and in-loop deblock against the JAX package's.

``intra_encode_frame`` in its full form (the IDR picture) and its masked
form (intra-in-P over a base recon), ``deblock_recon_device`` and the
fused IDR program ``i_frame_fused``.  Inputs: ``bench.make_clip`` frames
and seeded numpy integers, at 4x3 and 2x5 MBs.  Tolerance: exact equality
of every output array and plane, since this is an integer codec.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import make_clip

PAD = 32
LAM = np.float32(np.sqrt(0.85 * 2.0 ** ((30 - 12) / 3.0)))


def _t(a):
    return torch.tensor(np.asarray(a))


def _eq(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=what)


def _slices(gw, gh, rows_per_slice):
    """Availability maps of a picture cut into row slices."""
    from hartallo_tpu_torch.decode.intra_recon import (availability_masks,
                                                       availability_tl,
                                                       availability_tr)
    sid = (np.arange(gh) // rows_per_slice)[:, None].repeat(gw, 1)
    none = np.zeros((gh, gw), bool)
    return (*availability_masks(sid, False, none),
            availability_tr(sid, False, none),
            availability_tl(sid, False, none))


def _src_planes(gw, gh, t=0):
    from hartallo_tpu_torch.encode.e_device import pack_src
    W, H = gw * 16, gh * 16
    src = pack_src(make_clip(W, H, t + 1)[t], W, H, gw, gh)
    y = np.pad(src[:H].astype(np.int32), PAD, mode="edge")
    uv = src[H:].reshape(H // 2, 2, W // 2).astype(np.int32)
    return src, (y, np.pad(uv[:, 0], PAD, mode="edge"),
                 np.pad(uv[:, 1], PAD, mode="edge"))


@pytest.mark.parametrize("gw,gh,masked", [(4, 3, False), (2, 5, False),
                                          (4, 3, True)])
def test_intra_encode_frame(gw, gh, masked):
    from hartallo_tpu.encode.intra_encode import intra_encode_frame as J
    from hartallo_tpu_torch.encode.intra_encode import \
        intra_encode_frame as P
    rng = np.random.default_rng(50 + gw + gh + masked)
    _, planes = _src_planes(gw, gh)
    qp = rng.integers(20, 40, (gh, gw)).astype(np.int32)
    al, at, atr, atl = _slices(gw, gh, 2)
    extra_j, extra_p = {}, {}
    if masked:
        base = tuple(rng.integers(0, 256, p.shape).astype(np.int32)
                     for p in planes)
        mask = rng.integers(0, 2, (gh, gw)).astype(bool)
        extra_j = {"base_planes": tuple(jnp.asarray(b) for b in base),
                   "mb_mask": jnp.asarray(mask)}
        extra_p = {"base_planes": tuple(_t(b) for b in base),
                   "mb_mask": _t(mask)}
    want = J(*(jnp.asarray(p) for p in planes), jnp.asarray(qp), 2,
             jnp.asarray(al), jnp.asarray(at), jnp.float32(LAM),
             jnp.asarray(atr), jnp.asarray(atl), gw=gw, gh=gh, **extra_j)
    got = P(*(_t(p) for p in planes), _t(qp), 2, _t(al), _t(at), LAM,
            _t(atr), _t(atl), gw=gw, gh=gh, **extra_p)
    for name in want[3]:
        _eq(got[3][name], want[3][name], name)
    for g, w, name in zip(got[:3], want[:3], "YUV"):
        _eq(g, w, name)


@pytest.mark.parametrize("gw,gh", [(4, 3), (2, 5)])
def test_deblock_recon_device(gw, gh):
    from hartallo_tpu.encode.e_device import deblock_recon_device as J
    from hartallo_tpu_torch.encode.e_device import \
        deblock_recon_device as P
    rng = np.random.default_rng(60 + gw)
    H, W = gh * 16, gw * 16
    planes = tuple(rng.integers(0, 256, (h + 2 * PAD, w + 2 * PAD))
                   .astype(np.int32) for h, w in
                   ((H, W), (H // 2, W // 2), (H // 2, W // 2)))
    wq = rng.integers(-2, 3, (gh, gw, 16, 4, 4)).astype(np.int32) * \
        (rng.random((gh, gw, 16, 4, 4)) < 0.1)
    mv44 = rng.integers(-9, 10, (gh, gw, 4, 4, 2)).astype(np.int32)
    ref44 = rng.integers(0, 2, (gh, gw, 4, 4)).astype(np.int32)
    intra = rng.integers(0, 2, (gh, gw)).astype(bool)
    qp = rng.integers(15, 50, (gh, gw)).astype(np.int32)
    # picture edges are never filtered (the encoder's masks leave them
    # out; the JAX package's skewed layout reads undefined samples there)
    fmb_v = rng.integers(0, 2, (gh, gw)).astype(bool)
    fmb_v[:, 0] = False
    fmb_h = rng.integers(0, 2, (gh, gw)).astype(bool)
    fmb_h[0, :] = False
    for fv, fh in ((None, None), (fmb_v, fmb_h)):
        want = J(jnp.asarray(wq), jnp.asarray(mv44), jnp.asarray(ref44),
                 jnp.asarray(intra), jnp.asarray(qp), 1,
                 tuple(jnp.asarray(p) for p in planes), gw, gh,
                 fmb_v=None if fv is None else jnp.asarray(fv),
                 fmb_h=None if fh is None else jnp.asarray(fh))
        got = P(_t(wq), _t(mv44), _t(ref44), _t(intra), _t(qp), 1,
                tuple(_t(p) for p in planes), gw, gh, fmb_v=fv, fmb_h=fh)
        for g, w, name in zip(got, want, "YUV"):
            _eq(g, w, name)


@pytest.mark.parametrize("deblock", [True, False])
def test_i_frame_fused(deblock):
    from hartallo_tpu.encode.e_device import i_frame_fused as J
    from hartallo_tpu_torch.encode.e_device import i_frame_fused as P
    gw, gh = 4, 3
    src, _ = _src_planes(gw, gh)
    qp = np.full((gh, gw), 30, np.int32)
    al, at, atr, atl = _slices(gw, gh, 2)
    fmb_v, fmb_h = al, at          # deblock_slice_edges off (idc 2)
    args = (al, at, atr, atl, fmb_v, fmb_h)
    want = J(jnp.asarray(src), jnp.asarray(qp), jnp.float32(LAM),
             *(jnp.asarray(a) for a in args), gw=gw, gh=gh, chroma_qp_off=0,
             deblock=deblock)
    got = P(_t(src), _t(qp), LAM, *(_t(a) for a in args), gw=gw, gh=gh,
            chroma_qp_off=0, deblock=deblock)
    for g, w, name in zip(got, want, ("packed", "mad", "Y", "U", "V")):
        _eq(g, w, name)
