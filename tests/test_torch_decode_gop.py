"""The port's GOP scan ``decode_gop`` against the JAX package's
``d_gop.decode_gop`` on the dense packed batch of a 64x48x5 stream
encoded by ``hartallo_tpu``.

Both start from the same ring (zeros, then seeded noise) and decode the
same packed buffers.  Tolerance: exact equality of the output frames and
of the whole rings, since this is an integer codec.
"""
import numpy as np
import pytest
import torch

from _torch_port import encode_clip, queued_jobs, seeded_rings


@pytest.fixture(scope="module")
def batch():
    jobs, (gw, gh, S, cqoff) = queued_jobs(
        encode_clip(), eligible=lambda sd, wp: "send to the GOP scan")
    assert len(jobs) == 5 and all(j.packed is not None for j in jobs)
    packed = np.stack([j.packed for j in jobs])
    wslot = np.array([j.wslot for j in jobs], np.int32)
    hintra = np.array([j.has_intra for j in jobs], bool)
    assert hintra[0] and hintra.sum() >= 2               # intra-in-P too
    return packed, wslot, hintra, gw, gh, S, cqoff


@pytest.mark.parametrize("ring", ["zeros", "noise"])
def test_decode_gop_matches_jax(batch, ring):
    import jax.numpy as jnp

    from hartallo_tpu.decode.d_gop import decode_gop as jax_decode_gop
    from hartallo_tpu_torch.decode.d_gop import decode_gop, ring_shapes
    from hartallo_tpu_torch.decode.d_gop_fast import rings_from_numpy
    packed, wslot, hintra, gw, gh, S, cqoff = batch
    rings = (tuple(np.zeros(s, np.uint8) for s in ring_shapes(gw, gh, S))
             if ring == "zeros" else seeded_rings(gw, gh, S, seed=5))
    want = jax_decode_gop(jnp.asarray(packed), jnp.asarray(wslot),
                          jnp.asarray(hintra),
                          *(jnp.asarray(r) for r in rings),
                          gw=gw, gh=gh, chroma_qp_off=cqoff)
    tr = rings_from_numpy(*rings, "cpu")
    got = decode_gop(packed, wslot, hintra, *tr, gw=gw, gh=gh,
                     chroma_qp_off=cqoff)
    assert got[1] is tr[0]                               # updated in place
    for a, b in zip(got, want):
        assert a.dtype == torch.uint8
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
