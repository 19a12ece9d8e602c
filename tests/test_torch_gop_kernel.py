"""The whole-GOP decode kernel's plain torch twin against the JAX package's
Pallas kernel (interpret mode on the CPU), and the CUDA kernel against
its twin on a GPU.

Inputs: the ``d_pool.pack_fast`` payloads of a 64x48x5 stream encoded by
``hartallo_tpu`` (of the qcif_8 fixture for the GPU cases, which run
where JAX is absent), and a ring of seeded numpy noise.  Tolerance: exact
equality of the output frames and of the ring slots ([:Hp, :Wp], the part
a slot is read from), since this is an integer codec.
"""
import numpy as np
import pytest
import torch

from _torch_port import (cuda_device, encode_clip, load_fixture,  # noqa: F401
                         queued_jobs, seeded_rings)

STAGES = ["m", "mr", "mri", "mriwdsoh"]


@pytest.fixture(scope="module")
def batch():
    from hartallo_tpu.decode import d_pool
    from hartallo_tpu_torch.decode.d_gop_fast import stack_payload
    jobs, (gw, gh, S, cqoff) = queued_jobs(encode_clip())
    frames = [j.fast for j in jobs]
    assert len(frames) == 5 and all(f is not None for f in frames)
    assert any(f.ilist.shape[0] for f in frames)       # intra MBs present
    # the JAX package's capacity rule (decoder._flush_fast) and its
    # capacities, which the Pallas kernel needs
    mt = max(f.tags.shape[0] for f in frames)
    mi = max(f.ilist.shape[0] for f in frames)
    pay = stack_payload(frames,
                        nr=256 if mt <= 256 else d_pool.nrmax(gw, gh),
                        ni=32 if mi <= 32 else d_pool.nimax(gw, gh))
    return pay, gw, gh, S, cqoff, seeded_rings(gw, gh, S, seed=11)


def _decode_fast(pay, rings, gw, gh, stages, device):
    from hartallo_tpu_torch.decode import d_gop_fast as F
    p = F.payload_to(pay, device)
    r = F.rings_from_numpy(*rings, device)
    return F.decode_gop_fast(p["smb"], p["aux"], p["sf"], p["tags"],
                             p["vals"], p["ilist"], p["ivals"], *r,
                             gw=gw, gh=gh, stages=stages)


def _assert_same(a, b, gw, gh):
    Hp, Wp = gh * 16 + 64, gw * 16 + 64
    Hcp, Wcp = gh * 8 + 64, gw * 8 + 64
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1][:, :, :Hp, :Wp], b[1][:, :, :Hp, :Wp])
    for x, y in zip(a[2:], b[2:]):
        np.testing.assert_array_equal(x[:, :Hcp, :Wcp], y[:, :Hcp, :Wcp])


@pytest.mark.parametrize("stages", STAGES)
def test_plain_twin_equals_pallas_interpret(batch, stages):
    import jax.numpy as jnp

    from hartallo_tpu.decode.d_gop_pallas import decode_gop_pl
    pay, gw, gh, S, cqoff, rings = batch
    ref = decode_gop_pl(*(jnp.asarray(pay[k]) for k in
                          ("smb", "aux", "sf", "tags", "vals", "ilist",
                           "ivals")),
                        *(jnp.asarray(r) for r in rings), gw=gw, gh=gh,
                        chroma_qp_off=cqoff, interpret=True, stages=stages)
    out, rY, rU, rV = ref
    got = _decode_fast(pay, rings, gw, gh, stages, "cpu")
    _assert_same([np.asarray(x) for x in (out, rY, rU, rV)],
                 [t.numpy() for t in got], gw, gh)


def test_wrapper_rejects_mixed_devices(batch):
    from hartallo_tpu_torch.decode import d_gop_fast as F
    pay, gw, gh, S, cqoff, rings = batch
    p = F.payload_to(pay, "cpu")
    r = F.rings_from_numpy(*rings, "cpu")
    with pytest.raises(ValueError, match="CUDA device or all on the CPU"):
        F.decode_gop_fast(p["smb"], p["aux"], p["sf"], p["tags"], p["vals"],
                          p["ilist"], p["ivals"], r[0].to("meta"), r[1],
                          r[2], gw=gw, gh=gh, stages="mriwdsoh")
    # all-CPU tensors take the plain twin and never count a launch
    before = F.LAUNCHES
    F.decode_gop_fast(p["smb"], p["aux"], p["sf"], p["tags"], p["vals"],
                      p["ilist"], p["ivals"], *r, gw=gw, gh=gh, stages="m")
    assert F.LAUNCHES == before


@pytest.fixture(scope="module")
def qcif_batch():
    """The payloads of the qcif_8 fixture (no JAX needed: this runs on the
    machine with the GPU)."""
    from hartallo_tpu_torch.decode.d_gop_fast import stack_payload
    jobs, (gw, gh, S, cqoff) = queued_jobs(load_fixture("qcif_8")[0])
    pay = stack_payload([j.fast for j in jobs])
    return pay, gw, gh, S, cqoff, seeded_rings(gw, gh, S, seed=12)


@pytest.mark.cuda
@pytest.mark.parametrize("stages", STAGES)
def test_cuda_kernel_equals_plain_twin(cuda_device, qcif_batch, stages):
    from hartallo_tpu_torch.decode import d_gop_fast as F
    pay, gw, gh, S, cqoff, rings = qcif_batch
    before = F.LAUNCHES
    got = _decode_fast(pay, rings, gw, gh, stages, cuda_device)
    assert F.LAUNCHES == before + pay["smb"].shape[0]
    p = F.payload_to(pay, cuda_device)
    r = F.rings_from_numpy(*rings, cuda_device)
    ref = F.decode_gop_fast_plain(p["smb"], p["aux"], p["sf"], p["tags"],
                                  p["vals"], p["ilist"], p["ivals"], *r,
                                  gw=gw, gh=gh, stages=stages)
    torch.cuda.synchronize()
    _assert_same([t.cpu().numpy() for t in got],
                 [t.cpu().numpy() for t in ref], gw, gh)


@pytest.fixture(scope="module")
def hd_idr_batch():
    """The payload of the 720p_8 fixture's IDR picture: 3,600 intra MBs,
    which the Pallas kernel's list cannot hold and the CUDA kernel takes."""
    from hartallo_tpu_torch.decode.d_gop_fast import stack_payload
    jobs, (gw, gh, S, cqoff) = queued_jobs(load_fixture("720p_8")[0])
    assert jobs[0].fast.ilist.shape[0] == gw * gh == 3600
    pay = stack_payload([jobs[0].fast])
    return pay, gw, gh, S, cqoff, seeded_rings(gw, gh, S, seed=13)


@pytest.mark.cuda
@pytest.mark.parametrize("stages", ["mri", "mriwdsoh"])
def test_cuda_kernel_equals_plain_twin_720p_idr(cuda_device, hd_idr_batch,
                                                stages):
    from hartallo_tpu_torch.decode import d_gop_fast as F
    pay, gw, gh, S, cqoff, rings = hd_idr_batch
    got = _decode_fast(pay, rings, gw, gh, stages, cuda_device)
    p = F.payload_to(pay, cuda_device)
    r = F.rings_from_numpy(*rings, cuda_device)
    ref = F.decode_gop_fast_plain(p["smb"], p["aux"], p["sf"], p["tags"],
                                  p["vals"], p["ilist"], p["ivals"], *r,
                                  gw=gw, gh=gh, stages=stages)
    torch.cuda.synchronize()
    _assert_same([t.cpu().numpy() for t in got],
                 [t.cpu().numpy() for t in ref], gw, gh)
