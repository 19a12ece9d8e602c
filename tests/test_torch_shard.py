"""The port's row-sharded P encode step (``parallel/shard.py``) against
the JAX package's, tolerance 0, and the sharding helpers.

The JAX side runs on the virtual CPU devices of ``tests/conftest.py``,
its step compiled with ``jax.jit`` (called as it is, its ``shard_map``
runs op by op, four times slower here); the port's on a mesh that names
the CPU once per band.  The step is held at ``tests/test_shard.py``'s
size with bands of 2 MB rows and of 1 MB row (a band shorter than the
halo pad, so the halo is extended from the farthest fetched row).  The
sharded decode is ``tests/test_torch_shard_decode.py``.
"""
import numpy as np
import pytest
import torch

from _torch_port import cuda_device, load_fixture  # noqa: F401
from _torch_port import one_torch_thread, twin_checked_deblock  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_BANDS = 4
GW = 6
RNG = 8
QPV = 30
LAM = 4.0


def _content(gh):
    """test_shard.py's planes at gh MB rows: the source is the reference
    shifted with noise, so the ME finds real (vertical) motion."""
    r = np.random.default_rng(5)
    H, W = gh * 16, GW * 16
    refY = r.integers(0, 256, (H, W)).astype(np.int32)
    srcY = np.roll(refY, (3, -2), axis=(0, 1))
    srcY = np.clip(srcY + r.integers(-6, 7, (H, W)), 0, 255)
    refU, refV = (r.integers(0, 256, (H // 2, W // 2)).astype(np.int32)
                  for _ in range(2))
    srcU = np.clip(np.roll(refU, (1, -1), axis=(0, 1)) +
                   r.integers(-4, 5, (H // 2, W // 2)), 0, 255)
    srcV = np.clip(np.roll(refV, (1, -1), axis=(0, 1)) +
                   r.integers(-4, 5, (H // 2, W // 2)), 0, 255)
    return srcY, srcU, srcV, refY, refU, refV


def _port_step(devices, planes, gh, **kw):
    from hartallo_tpu_torch.parallel.shard import (Mesh, gather,
                                                   p_encode_step_sharded)
    out = p_encode_step_sharded(
        Mesh(devices), *planes, np.full((gh, GW), QPV, np.int32), LAM,
        gw=GW, gh=gh, rng=RNG, **kw)
    return [gather(o, "cpu").numpy() for o in out]


@pytest.mark.parametrize("gh", [8, 4], ids=["2-mb-row-bands",
                                            "1-mb-row-bands"])
def test_p_step_matches_jax(gh):
    import jax
    import hartallo_tpu.parallel.shard as JS
    planes = _content(gh)
    step = jax.jit(JS.p_encode_step_sharded, static_argnums=(0,),
                   static_argnames=("gw", "gh", "rng"))
    want = step(JS.make_mesh(N_BANDS), *planes,
                np.full((gh, GW), QPV, np.int32), lam=LAM, gw=GW, gh=gh,
                rng=RNG)
    got = _port_step(("cpu",) * N_BANDS, planes, gh)
    names = ("wq", "dcq", "acq", "mv44", "choice", "recY", "recU", "recV")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


def test_one_band_step_is_the_whole_frame_step():
    """On a one-device mesh the step is p_frame_device and the deblock of
    the whole frame."""
    from hartallo_tpu_torch.decode.intra_recon import PAD
    from hartallo_tpu_torch.encode.p_device import p_frame_device
    from hartallo_tpu_torch.ops.wide import pad_edge
    from hartallo_tpu_torch.parallel.shard import _shard_deblock
    gh = 4
    planes = _content(gh)
    got = _port_step(("cpu",), planes, gh)
    qp = torch.full((gh, GW), QPV, dtype=torch.int32)
    t = [pad_edge(torch.as_tensor(p).to(torch.int32)) for p in planes]
    wq, dcq, acq, mv44, choice, recY, recU, recV, _ = p_frame_device(
        *t, qp, LAM, gw=GW, gh=gh, rng=RNG, refine=True, chroma_qp_off=0)
    recY, recU, recV = _shard_deblock(wq, mv44, qp, 0, (recY, recU, recV),
                                      GW, gh)
    H, W = gh * 16, GW * 16
    want = (wq, dcq, acq, mv44, choice, recY[PAD:PAD + H, PAD:PAD + W],
            recU[PAD:PAD + H // 2, PAD:PAD + W // 2],
            recV[PAD:PAD + H // 2, PAD:PAD + W // 2])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


def test_halo_exchange_beats_edge_replication():
    """Vertical motion across a band boundary must be findable: with real
    halos the ME matches the neighbour band's true content, which edge
    replication cannot provide."""
    gh = 8
    mv44 = _port_step(("cpu",) * N_BANDS, _content(gh), gh)[3]
    gh_l = gh // N_BANDS
    vy = mv44[[s * gh_l for s in range(1, N_BANDS)], :, :, :, 1]
    assert (vy != 0).mean() > 0.5, "boundary MBs found no vertical motion"


def test_halo_pad_short_band_extends_farthest_row():
    """A band shorter than PAD takes all of each neighbour's rows and
    repeats the farthest one; the outer bands edge-replicate."""
    from hartallo_tpu_torch.decode.intra_recon import PAD
    from hartallo_tpu_torch.parallel.shard import _halo_pad
    rows = torch.arange(3 * 8, dtype=torch.int32)[:, None].expand(24, 5)
    bands = [rows[8 * i:8 * (i + 1)] for i in range(3)]
    mid = _halo_pad(bands, 1)
    assert mid.shape == (8 + 2 * PAD, 5 + 2 * PAD)
    col = mid[:, 0].tolist()
    assert col == [0] * (PAD - 7) + list(range(1, 8)) + \
        list(range(8, 16)) + list(range(16, 24)) + [23] * (PAD - 8)
    top = _halo_pad(bands, 0)[:, 3].tolist()
    assert top[:PAD] == [0] * PAD and top[PAD + 8:PAD + 16] == \
        list(range(8, 16))


def test_make_mesh_raises_without_enough_devices():
    from hartallo_tpu_torch.parallel.shard import Mesh, make_mesh
    with pytest.raises(RuntimeError):
        make_mesh(torch.cuda.device_count() + 1)
    assert make_mesh(1, device_type="cpu").devices == (
        torch.device("cpu", 0),)
    assert Mesh(("cpu",) * 2).devices == (torch.device("cpu"),) * 2


@pytest.mark.parametrize("name", ["shard_96x64_8", "shard_1080p_8",
                                  "qcif_6_tl2", "svc_il_4"])
def test_split_gops_matches_jax(name):
    import hartallo_tpu.parallel.shard as JS
    from hartallo_tpu_torch.parallel.shard import split_gops
    stream, meta = load_fixture(name)
    gops = split_gops(stream)
    assert gops == JS.split_gops(stream)
    assert b"".join(gops).endswith(stream[-64:])
    if "layers" not in meta:      # (an SVC stream's prefix NAL before its
        # first IDR slice makes a GOP of its own, in both packages)
        assert len(gops) == -(-meta["frames"] // meta["gop_size"])


def test_dense_packed_leaves_the_default_path_alone():
    """The default decoder gives kernel-eligible pictures the kernel's
    payload and no dense buffer; a decoder with ``dense_packed`` (the
    sharded decoder's setting) gives every picture the dense buffer and
    no payload, and both decode the fixture's frames."""
    from hartallo_tpu_torch.decode.decoder import Decoder
    from hartallo_tpu_torch.parallel.shard import ShardedDecoder
    from hartallo_tpu_torch.util.checks import plane_md5

    class Dense(Decoder):
        dense_packed = True

    stream, meta = load_fixture("qcif_6_tl2")
    runs = []
    for cls in (Decoder, Dense):
        dec = cls(device="cpu", batch_k=1 << 30)
        pending = dec.enqueue_annexb(stream, tolerant=False)
        jobs = list(dec.layer.jobs)
        dec.flush_all()
        runs.append((jobs, [plane_md5(r.frame.resolve()) for r in pending]))
    (plain_jobs, plain_md5), (dense_jobs, dense_md5) = runs
    assert plain_md5 == dense_md5 == meta["frame_md5"]
    assert all(j.fast is not None and j.packed is None for j in plain_jobs)
    assert all(j.fast is None and j.packed is not None for j in dense_jobs)
    assert not Decoder.dense_packed and ShardedDecoder.dense_packed


@pytest.mark.cuda
def test_cuda_sharded_step(cuda_device, twin_checked_deblock):
    """On the card, on a mesh that repeats it: the step equals the CPU
    mesh's, and each band's deblock equals the plain twin."""
    for gh in (8, 4):
        planes = _content(gh)
        want = _port_step(("cpu",) * N_BANDS, planes, gh)
        del twin_checked_deblock[:]
        got = _port_step(("cuda:0",) * N_BANDS, planes, gh)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert twin_checked_deblock == [(GW, gh // N_BANDS)] * N_BANDS
