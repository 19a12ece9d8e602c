"""The port's row-sharded decode (``parallel/shard.py``:
``decode_gops_grouped``, ``decode_frame_step_sharded``) against the JAX
package's and against the port's plain decode, tolerance 0.

``shard_96x64_8`` is ``__graft_entry__``'s sharded-decode stream at 4 MB
rows and 8 pictures (one slice per MB row without deblocking across
slice edges, GOPs of 4, two temporal layers, intra MBs in the P
pictures), written by the JAX package, which also decoded it with its
``decode_gops_grouped`` to the same frames.  On a mesh of 8 devices with
2 groups, each GOP decodes in 4 bands of one MB row, shorter than the
halo pad.  The live cross-check runs the JAX package's grouped decode
with its per-picture step compiled by ``jax.jit`` (called as it is, its
``shard_map`` runs op by op, some ten minutes here).

``shard_slices_96x64_8`` is the same clip in slices that start mid-row
inside a band (2 bands of 2 MB rows, each cut into slices of 9 and 3
MBs), where a band's intra MBs see slice edges inside the band: the
port's sharded decode passes each MB's parsed above-right availability
to the intra wavefront, the JAX package's passes none (all available);
its JSON records that the JAX package's grouped decode gave the
decoder's frames all the same.
"""
import numpy as np
import pytest

from _torch_port import cuda_device, load_fixture  # noqa: F401
from _torch_port import one_torch_thread, twin_checked_deblock  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FIXTURE = "shard_96x64_8"
DEVICES = 8


def _md5s(frames):
    from hartallo_tpu_torch.util.checks import plane_md5
    return [plane_md5(np.asarray(f)) for f in frames]


def test_grouped_decode_matches_fixture_and_plain_decode():
    from hartallo_tpu_torch.api import Codec, CodecConfig
    from hartallo_tpu_torch.parallel.shard import Mesh, decode_gops_grouped
    stream, meta = load_fixture(FIXTURE)
    got = decode_gops_grouped(Mesh(("cpu",) * DEVICES), stream, groups=2)
    plain = Codec(CodecConfig(), device="cpu").decode_annexb(
        stream, tolerant=False)
    assert meta["jax_decode_gops_grouped"]["equal"]
    assert _md5s(got) == _md5s(r.frame for r in plain) == \
        meta["frame_md5"]


def test_grouped_decode_of_mid_row_slices():
    """Slices that start mid-row inside a band: the grouped decode on 2
    groups of 2 bands equals the JAX decoder's frames and the port's
    plain decode."""
    from hartallo_tpu_torch.api import Codec, CodecConfig
    from hartallo_tpu_torch.bitio import (BitReader, find_nal_units,
                                          strip_emulation_prevention)
    from hartallo_tpu_torch.parallel.shard import Mesh, decode_gops_grouped
    stream, meta = load_fixture("shard_slices_96x64_8")
    gw, gh = meta["width"] // 16, meta["height"] // 16
    band_mbs = gw * gh // meta["bands"]
    first = []
    for s0, e0 in find_nal_units(stream):
        if stream[s0] & 0x1F in (1, 5):
            r = BitReader(strip_emulation_prevention(stream[s0:e0]))
            r.u(8)
            first.append(r.ue())
    assert sorted(set(first)) == [0, 9, 12, 21]
    assert all(f % band_mbs in (0, meta["slice_mbs"]) for f in first)
    got = decode_gops_grouped(Mesh(("cpu",) * 4), stream, groups=2)
    plain = Codec(CodecConfig(), device="cpu").decode_annexb(
        stream, tolerant=False)
    assert _md5s(got) == _md5s(r.frame for r in plain) == \
        meta["frame_md5"]
    jax_grouped = meta["jax_decode_gops_grouped"]
    assert (jax_grouped["devices"], jax_grouped["equal"],
            jax_grouped["differences"]) == (4, True, [])


def test_grouped_decode_matches_jax_live(monkeypatch):
    import jax
    # imported before the step is traced: their module-level arrays must
    # not be created under the trace
    import hartallo_tpu.decode.d_gop  # noqa: F401
    import hartallo_tpu.decode.intra_recon  # noqa: F401
    import hartallo_tpu.ops.deblock  # noqa: F401
    import hartallo_tpu.ops.wide  # noqa: F401
    import hartallo_tpu.parallel.shard as JS
    from hartallo_tpu_torch.parallel.shard import Mesh, decode_gops_grouped
    stream, _ = load_fixture(FIXTURE)
    assert len(jax.devices()) >= DEVICES
    step = jax.jit(JS.decode_frame_step_sharded, static_argnums=(0,),
                   static_argnames=("gw", "gh", "chroma_qp_off",
                                    "has_intra", "S"))

    def host_rings(mesh, packed, *rings_and_wslot, **kw):
        # the rings go in as host arrays every time, as they do the first
        # time, so that the step compiles once per (mesh, has_intra)
        rY, rU, rV, wslot = rings_and_wslot
        return step(mesh, packed, *(np.asarray(r) for r in (rY, rU, rV)),
                    wslot, **kw)
    monkeypatch.setattr(JS, "decode_frame_step_sharded", host_rings)
    want = JS.decode_gops_grouped(JS.make_mesh(DEVICES), stream, groups=2)
    got = decode_gops_grouped(Mesh(("cpu",) * DEVICES), stream, groups=2)
    assert len(got) == len(want) == 8
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"frame {i}")


def test_step_keeps_rings_per_band():
    """One picture through ``decode_frame_step_sharded`` with rings cut
    into bands: the outputs and rings come back per band, and the bands
    joined are the picture the plain decode gives."""
    import torch
    from hartallo_tpu_torch.parallel.shard import (Mesh, ShardedDecoder,
                                                   _split,
                                                   decode_frame_step_sharded,
                                                   gather)
    stream, meta = load_fixture(FIXTURE)
    mesh = Mesh(("cpu",) * 4)
    dec = ShardedDecoder(mesh)
    dec.batch_k = 1 << 30                 # queue, do not decode
    dec.enqueue_annexb(stream, tolerant=False)
    job = dec.layer.jobs[0]
    gw, gh, S, cqoff = dec.layer.ring_key
    H, W = gh * 16, gw * 16
    rings = [_split(np.zeros((S, h, w), np.int32), mesh, dim=1)
             for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    y, uv, *bands = decode_frame_step_sharded(
        mesh, job.packed, *rings, job.wslot, gw=gw, gh=gh,
        chroma_qp_off=cqoff, has_intra=job.has_intra, S=S)
    assert len(y) == len(uv) == 4 and all(len(b) == 4 for b in bands)
    assert all(t.shape == (16, W) for t in y)
    frame = torch.cat([gather(y), gather(uv)]).numpy()
    uvp = frame[H:].reshape(H // 2, 2, W // 2)
    i420 = np.concatenate([frame[:H].ravel(), uvp[:, 0].ravel(),
                           uvp[:, 1].ravel()])
    assert _md5s([i420]) == meta["frame_md5"][:1]
    # the rings are cut on their row axis: slot wslot of every band
    ringY = torch.cat([b[job.wslot] for b in bands[0]])
    np.testing.assert_array_equal(ringY.numpy(), frame[:H])


@pytest.mark.cuda
def test_cuda_grouped_decode(cuda_device, twin_checked_deblock):
    """On the card, on a mesh that repeats it: every frame equals the
    fixture's and every band's deblock equals the plain twin."""
    from hartallo_tpu_torch.parallel.shard import Mesh, decode_gops_grouped
    stream, meta = load_fixture(FIXTURE)
    frames = decode_gops_grouped(Mesh(("cuda:0",) * DEVICES), stream,
                                 groups=2)
    assert _md5s(frames) == meta["frame_md5"]
    assert twin_checked_deblock == [(6, 1)] * (4 * meta["frames"])


@pytest.mark.cuda
def test_cuda_intra_replay_follows_its_inputs(cuda_device):
    """``ops/graphs.replayed`` runs the intra wavefront of a band eagerly,
    then records it into a CUDA graph, then replays it: each of the four
    calls, on new inputs, equals the wavefront on the CPU."""
    import torch
    from hartallo_tpu_torch.decode.intra_recon import PAD, intra_reconstruct
    from hartallo_tpu_torch.ops.graphs import replayed
    gw, gh = 5, 3
    rng = np.random.default_rng(7)

    def intra(pY, pU, pV, *rest):
        return intra_reconstruct((pY, pU, pV), *rest, gw=gw, gh=gh)

    for _ in range(4):
        args = [rng.integers(0, 256, (gh * s + 2 * PAD, gw * s + 2 * PAD))
                for s in (16, 8, 8)]
        args += [rng.integers(-40, 41, (gh, gw, 16, 16)),
                 rng.integers(-40, 41, (gh, gw, 2, 8, 8)),
                 rng.integers(0, 3, (gh, gw)), rng.integers(0, 4, (gh, gw)),
                 rng.integers(0, 9, (gh, gw, 16)),
                 rng.integers(0, 4, (gh, gw))]
        args = [torch.as_tensor(a, dtype=torch.int32) for a in args]
        args += [torch.as_tensor(rng.integers(0, 2, (gh, gw)) > 0)
                 for _ in range(3)]
        want = intra(*args)
        got = replayed(intra, "test_intra", *(a.to(cuda_device)
                                              for a in args))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
