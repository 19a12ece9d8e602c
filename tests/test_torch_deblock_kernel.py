"""The standalone deblock kernel's plain twin against the JAX package's
Pallas kernel (interpret mode on the CPU), its routing, and the CUDA
kernel against the twin on a GPU.

Inputs are made as ``tests/test_deblock_pallas.py`` makes them: seeded
planes, bS in 0..4, QPs and nonzero alpha/beta offsets, except that the
picture-edge bS are 0.  No picture edge is ever filtered (the spec's
filter flags and every caller leave them out), and there the JAX
package's skewed layout reads undefined neighbours while the port reads
the pad.  Tolerance: exact equality of the three planes.
"""
import numpy as np
import pytest
import torch

from _torch_port import cuda_device  # noqa: F401

PAD = 32


def _inputs(gw, gh, seed):
    """(planes, the other ten arguments) as numpy int32."""
    H, W = gh * 16, gw * 16
    rng = np.random.default_rng(seed)
    planes = tuple(rng.integers(0, 256, (h + 2 * PAD, w + 2 * PAD))
                   .astype(np.int32) for h, w in
                   ((H, W), (H // 2, W // 2), (H // 2, W // 2)))
    bs_v = rng.integers(0, 5, (gh, gw, 4, 4)).astype(np.int32)
    bs_h = rng.integers(0, 5, (gh, gw, 4, 4)).astype(np.int32)
    bs_v[:, 0, 0] = 0                                   # picture edges
    bs_h[0, :, 0] = 0
    rest = (bs_v, bs_h,
            *[rng.integers(10, 50, (gh, gw)).astype(np.int32)
              for _ in range(3)],
            *[rng.integers(10, 40, (gh, gw)).astype(np.int32)
              for _ in range(3)],
            (rng.integers(-4, 5, (gh, gw)) * 2).astype(np.int32),
            (rng.integers(-4, 5, (gh, gw)) * 2).astype(np.int32))
    return planes, rest


def _run(fn, planes, rest, gw, gh, device):
    return fn(tuple(torch.tensor(p, device=device) for p in planes),
              *(torch.tensor(a, device=device) for a in rest), gw=gw, gh=gh)


# the CPU case of tests/test_deblock_pallas.py, and one of its TPU sizes
@pytest.mark.parametrize("gw,gh,seed", [(4, 3, 2), (6, 5, 2)])
def test_plain_twin_equals_pallas_interpret(gw, gh, seed):
    import jax.numpy as jnp

    from hartallo_tpu.ops.deblock_pallas import deblock_frame_pl
    from hartallo_tpu_torch.ops.deblock_fast import deblock_frame_fast_plain
    planes, rest = _inputs(gw, gh, seed)
    want = deblock_frame_pl(tuple(jnp.asarray(p) for p in planes),
                            *(jnp.asarray(a) for a in rest), gw=gw, gh=gh,
                            interpret=True)
    got = _run(deblock_frame_fast_plain, planes, rest, gw, gh, "cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert any(not np.array_equal(np.asarray(w), p)
               for w, p in zip(want, planes))            # it filtered


def test_cpu_tensors_take_the_plain_twin():
    from hartallo_tpu_torch.ops import deblock_fast as F
    planes, rest = _inputs(5, 4, 7)
    before = F.LAUNCHES
    got = _run(F.deblock_frame_fast, planes, rest, 5, 4, "cpu")
    want = _run(F.deblock_frame_fast_plain, planes, rest, 5, 4, "cpu")
    assert F.LAUNCHES == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_inputs_stay_untouched_and_devices_must_agree():
    from hartallo_tpu_torch.ops import deblock_fast as F
    planes, rest = _inputs(3, 2, 8)
    tp = tuple(torch.tensor(p) for p in planes)
    F.deblock_frame_fast(tp, *(torch.tensor(a) for a in rest), gw=3, gh=2)
    for t, p in zip(tp, planes):
        np.testing.assert_array_equal(t.numpy(), p)
    with pytest.raises(ValueError, match="CUDA device or all on the CPU"):
        F.deblock_frame_fast((tp[0].to("meta"), tp[1], tp[2]),
                             *(torch.tensor(a) for a in rest), gw=3, gh=2)


def slice_edge_flags(rest, gh, seed):
    """The inputs with the filter flags of a picture cut into slices of a
    few MB rows each: disable_deblocking_filter_idc 2 (no filtering across
    a slice edge: the H edge 0 of each slice's first row gets bS 0) on
    every other slice, idc 1 (no filtering at all) on some MBs."""
    bs_v, bs_h = rest[0].copy(), rest[1].copy()
    rng = np.random.default_rng(seed)
    first = np.unique(np.r_[0, np.sort(rng.choice(np.arange(1, gh), gh // 3,
                                                  replace=False))])
    for k, y in enumerate(first):
        if k % 2:
            bs_h[y, :, 0] = 0
    off = rng.random(bs_v.shape[:2]) < 0.1
    bs_v[off] = 0
    bs_h[off] = 0
    return (bs_v, bs_h, *rest[2:])


# CIF, 720p and 1080p (1088 coded rows) MB grids, and the 720p grid with
# slice-edge and idc 1 filter flags
@pytest.mark.cuda
@pytest.mark.parametrize("gw,gh,flags", [(22, 18, False), (80, 45, False),
                                         (120, 68, False), (80, 45, True)])
def test_cuda_kernel_equals_plain_twin(cuda_device, gw, gh, flags):
    from hartallo_tpu_torch.ops import deblock_fast as F
    planes, rest = _inputs(gw, gh, gw + gh)
    if flags:
        rest = slice_edge_flags(rest, gh, gw)
    before = F.LAUNCHES
    got = _run(F.deblock_frame_fast, planes, rest, gw, gh, cuda_device)
    assert F.LAUNCHES == before + 1
    want = _run(F.deblock_frame_fast_plain, planes, rest, gw, gh,
                cuda_device)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())
