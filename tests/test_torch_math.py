"""The port's distortion and activity helpers (``ops/math.py``), its
``ops/interpol.pad_plane`` and its ``util/checks`` against the JAX
package's, on the same seeded numpy inputs, tolerance 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch


def _blocks(seed, n, size=4):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, size, size)),
            rng.integers(0, 256, (n, size, size)))


@pytest.mark.parametrize("name", ["satd4x4", "mae4x4", "mse4x4"])
def test_block_metrics_match_jax(name):
    import hartallo_tpu.ops.math as J
    import hartallo_tpu_torch.ops.math as P
    a, b = _blocks(0, 64)
    a[0] = b[0]                                   # a zero-distortion block
    got = getattr(P, name)(torch.as_tensor(a), torch.as_tensor(b))
    want = getattr(J, name)(jnp.asarray(a), jnp.asarray(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[0]) == 0


def test_satd4x4_np_matches_jax_and_batched():
    import hartallo_tpu.ops.math as J
    import hartallo_tpu_torch.ops.math as P
    a, b = _blocks(1, 32)
    got = [P.satd4x4_np(a[i], b[i]) for i in range(32)]
    assert got == [J.satd4x4_np(a[i], b[i]) for i in range(32)]
    assert got == P.satd4x4(torch.as_tensor(a), torch.as_tensor(b)).tolist()


def test_homogeneousity8x8_matches_jax():
    import hartallo_tpu.ops.math as J
    import hartallo_tpu_torch.ops.math as P
    blk = np.random.default_rng(2).integers(0, 256, (2, 8, 8, 8))
    blk[0, 0] = 7                                 # a flat block
    got = P.homogeneousity8x8(torch.as_tensor(blk))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(J.homogeneousity8x8(jnp.asarray(blk))))
    assert int(got[0, 0]) == 0


def test_pad_plane_matches_jax():
    from hartallo_tpu.ops.interpol import pad_plane as jax_pad
    from hartallo_tpu_torch.ops.interpol import PAD, pad_plane
    p = np.random.default_rng(3).integers(0, 256, (48, 80)).astype(np.int32)
    got = pad_plane(p)
    assert got.shape == (48 + 2 * PAD, 80 + 2 * PAD)
    np.testing.assert_array_equal(got, jax_pad(p))


def test_checks_match_jax():
    import hartallo_tpu.util.checks as J
    import hartallo_tpu_torch.util.checks as P
    W, H = 48, 32
    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, W * H * 3 // 2).astype(np.uint8)
    b = np.clip(a.astype(np.int32) + rng.integers(-3, 4, a.size), 0,
                255).astype(np.uint8)
    assert P.plane_md5(a) == J.plane_md5(a)
    assert P.frame_md5(a, W, H) == J.frame_md5(a, W, H)
    assert P.psnr(a, b) == J.psnr(a, b) and P.psnr(a, a) == float("inf")
    assert P.frame_psnr_yuv(a, b, W, H) == J.frame_psnr_yuv(a, b, W, H)
