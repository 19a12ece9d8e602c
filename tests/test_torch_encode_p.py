"""The port's P-picture encode programs against the JAX package's.

``p_frame_device`` (full search, partition choice, sub-pel refinement,
residual and recon, and the winning ME cost that decides intra-in-P),
``p_frame_fused`` and ``p_gop_fused``.  The source is a ``bench.make_clip``
frame with one flat MB pasted in, where the ME cost loses to the intra
estimate, so the intra-in-P branch runs; the reference is the JAX
package's own IDR recon, turned into the port's tensors by
``e_device.ref_planes_from_numpy``.  4x3 MBs.  Tolerance: exact equality
of every output, the f32 ME cost included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import make_clip

PAD = 32
GW, GH = 4, 3
LAM = np.float32(np.sqrt(0.85 * 2.0 ** ((30 - 12) / 3.0)))


def _t(a):
    return torch.tensor(np.asarray(a))


def _eq(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=what)


def _masks():
    al = np.zeros((GH, GW), bool)
    al[:, 1:] = True
    at = np.zeros((GH, GW), bool)
    at[1:, :] = True
    atr = np.zeros((GH, GW), bool)
    atr[1:, :-1] = True
    atl = np.zeros((GH, GW), bool)
    atl[1:, 1:] = True
    return al, at, atr, atl


@pytest.fixture(scope="module")
def clip():
    """(packed sources of 4 frames, the JAX IDR recon of frame 0)."""
    from hartallo_tpu.encode.e_device import i_frame_fused
    from hartallo_tpu_torch.encode.e_device import pack_src
    W, H = GW * 16, GH * 16
    srcs = [pack_src(f, W, H, GW, GH) for f in make_clip(W, H, 4)]
    for s in srcs[1:]:
        s[16:32, 16:32] = 77                   # a flat MB: intra-in-P
    al, at, atr, atl = _masks()
    out = i_frame_fused(jnp.asarray(srcs[0]),
                        jnp.full((GH, GW), 30, jnp.int32), jnp.float32(LAM),
                        *(jnp.asarray(a) for a in (al, at, atr, atl, al, at)),
                        gw=GW, gh=GH, chroma_qp_off=0, deblock=True)
    return srcs, tuple(np.asarray(p) for p in out[2:])


def _split(src):
    H, W = GH * 16, GW * 16
    y = np.pad(src[:H].astype(np.int32), PAD, mode="edge")
    uv = src[H:].reshape(H // 2, 2, W // 2).astype(np.int32)
    return (y, np.pad(uv[:, 0], PAD, mode="edge"),
            np.pad(uv[:, 1], PAD, mode="edge"))


@pytest.mark.parametrize("refine", [True, False])
def test_p_frame_device(clip, refine):
    from hartallo_tpu.encode.p_device import p_frame_device as J
    from hartallo_tpu_torch.encode.e_device import ref_planes_from_numpy
    from hartallo_tpu_torch.encode.p_device import p_frame_device as P
    srcs, ref = clip
    src = _split(srcs[1])
    qp = np.random.default_rng(70).integers(24, 36, (GH, GW)) \
        .astype(np.int32)
    want = J(*(jnp.asarray(a) for a in src + ref), jnp.asarray(qp),
             float(LAM), gw=GW, gh=GH, rng=12, refine=refine,
             chroma_qp_off=1)
    got = P(*(_t(a) for a in src), *ref_planes_from_numpy(ref, "cpu"),
            _t(qp), LAM, gw=GW, gh=GH, rng=12, refine=refine,
            chroma_qp_off=1)
    names = ("wq", "dcq", "acq", "mv44", "choice", "Y", "U", "V",
             "best_cost")
    for g, w, name in zip(got, want, names):
        _eq(g, w, name)


def _p_args(intra_in_p):
    al, at, atr, atl = _masks()
    return dict(fmb_v=al, fmb_h=at, avail=(al, at, atr, atl),
                kw=dict(gw=GW, gh=GH, rng=12, refine=True, chroma_qp_off=0,
                        deblock=True, intra_in_p=intra_in_p))


@pytest.mark.parametrize("intra_in_p", [True, False])
def test_p_frame_fused(clip, intra_in_p):
    from hartallo_tpu.encode.e_device import P_FIELDS, unpack
    from hartallo_tpu.encode.e_device import p_frame_fused as J
    from hartallo_tpu_torch.encode.e_device import p_frame_fused as P
    from hartallo_tpu_torch.encode.e_device import ref_planes_from_numpy
    srcs, ref = clip
    a = _p_args(intra_in_p)
    qp = np.full((GH, GW), 30, np.int32)
    want = J(jnp.asarray(srcs[1]), *(jnp.asarray(r) for r in ref),
             jnp.asarray(qp), jnp.float32(LAM), jnp.asarray(a["fmb_v"]),
             jnp.asarray(a["fmb_h"]), *(jnp.asarray(m) for m in a["avail"]),
             **a["kw"])
    got = P(_t(srcs[1]), *ref_planes_from_numpy(ref, "cpu"), _t(qp), LAM,
            a["fmb_v"], a["fmb_h"], *(_t(m) for m in a["avail"]),
            **a["kw"])
    for g, w, name in zip(got, want, ("packed", "mad", "Y", "U", "V")):
        _eq(g, w, name)
    is_intra = unpack(np.asarray(want[0]).astype(np.int32), P_FIELDS, GH,
                      GW)["is_intra"]
    assert is_intra.any() == intra_in_p


def test_p_gop_fused(clip):
    from hartallo_tpu.encode.e_device import p_gop_fused as J
    from hartallo_tpu_torch.encode.e_device import p_gop_fused as P
    from hartallo_tpu_torch.encode.e_device import ref_planes_from_numpy
    srcs, ref = clip
    a = _p_args(True)
    K = 3
    src_k = np.stack(srcs[1:1 + K])
    qp_k = np.stack([np.full((GH, GW), q, np.int32) for q in (30, 26, 34)])
    lam_k = np.asarray([np.sqrt(0.85 * 2.0 ** ((q - 12) / 3.0))
                        for q in (30, 26, 34)], np.float32)
    is_ref = np.asarray([True, False, True])   # a droppable middle frame
    want = J(jnp.asarray(src_k), *(jnp.asarray(r) for r in ref),
             jnp.asarray(qp_k), jnp.asarray(lam_k), jnp.asarray(a["fmb_v"]),
             jnp.asarray(a["fmb_h"]), jnp.asarray(is_ref),
             *(jnp.asarray(m) for m in a["avail"]), **a["kw"])
    got = P(_t(src_k), *ref_planes_from_numpy(ref, "cpu"), _t(qp_k),
            _t(lam_k), a["fmb_v"], a["fmb_h"], is_ref,
            *(_t(m) for m in a["avail"]), **a["kw"])
    for g, w, name in zip(got, want, ("packed", "mad", "Y", "U", "V")):
        _eq(g, w, name)
