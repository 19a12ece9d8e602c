"""The GOP scan's residual, MC and ring write: the plain twins against the
JAX package, the port's ``decode_gop`` against JAX's on a batch that
takes every MC case, the routing of the scan, the sharded band step and
the SVC encoder's inter-layer prediction, and the CUDA kernels against
the twins on a GPU.

- The twins (``decode/mc_decode_fast``): ``residual_planes_plain``
  equals the JAX ``ops/wide.residual_planes_wide`` on
  ``chip_smoke.residual_rec_inputs`` (int16-extreme coefficients, qp
  0..51, I16 MBs) at chroma QP offsets -12, 0 and 12; ``mc_recon_plain``
  equals the JAX scan step's MC lines (``mc_luma_plane``,
  ``mc_chroma_plane`` twice, the masked clipped residual add and the
  zero pad, ``decode/d_gop.py:183-191``) on ``chip_smoke.mc_dec_inputs``
  (per-4x4 MVs up to 2,000 quarter pels out, three slots, weights with
  logWD 0..7; the uint8 ring and the int32 band stacks);
  ``ring_write_plain`` equals the JAX step's ring write and output
  (``:208-229``) on ``chip_smoke.ring_write_inputs``.
- ``decode_gop`` equals the JAX ``decode_gop`` on the 64x48 batch of
  ``tests/test_torch_decode_gop.py`` with its MV words redrawn per 4x4
  block (sub-8x8 motion, far outside the picture), its refIdx per 8x8
  over the ring's slots and seeded explicit weights: the output frames
  and the whole rings.
- ``encode/svc._ilp_predict`` through ``halfpel_planes_fast`` and
  ``mc_recon_fast`` equals the plain composition it replaced.
- Routing on the CPU: the scan calls the residual wrapper once a batch
  and the MC and ring write wrappers once a picture; the sharded band
  step the residual and MC wrappers once a band and no ring write.
- On a GPU (``cuda``): each kernel equals its twin at QCIF to 1080p,
  the 120x34 band and the emulated tests' shapes, the MC also on
  coherent motion; the scan route (``qcif_6_wp``), the sharded decode
  (``shard_96x64_8``) and ``_ilp_predict`` run with ``mc_luma_plane``,
  ``mc_chroma_plane``, ``residual_planes_wide`` and ``halfpel_planes``
  (and on the scan route ``pad_edge``) raising on a CUDA tensor.

Tolerance: exact equality.
"""
import collections

import numpy as np
import pytest
import torch

import chip_smoke as CS
from _torch_port import (cuda_device, encode_clip, load_fixture,  # noqa: F401
                         queued_jobs, seeded_rings)

PAD = 32


def _jax_residual(rec, offs, cqo, gw, gh):
    import jax.numpy as jnp
    from hartallo_tpu.core.tables import QP_SCALE_CHROMA
    from hartallo_tpu.ops.wide import residual_planes_wide
    M = rec.shape[0] * rec.shape[1]
    la, ld, ca, cd, qp, kind = offs
    r = jnp.asarray(rec)
    return residual_planes_wide(
        r[:, :, la:la + 256].reshape(M, 16, 16),
        r[:, :, ld:ld + 16].reshape(M, 16),
        r[:, :, ca:ca + 128].reshape(M, 2, 4, 16),
        r[:, :, cd:cd + 8].reshape(M, 2, 4), r[:, :, qp].reshape(M),
        (r[:, :, kind] == 1).reshape(M), cqo, jnp.asarray(QP_SCALE_CHROMA),
        gw, gh)


@pytest.mark.parametrize("cqo", [-12, 0, 12])
def test_residual_twin_equals_jax(cqo):
    from hartallo_tpu_torch.decode.mc_decode_fast import residual_planes_fast
    gw, gh, K = 5, 3, 2
    rec, offs = CS.residual_rec_inputs(gw, gh, K, 30 + cqo)
    got = residual_planes_fast(torch.tensor(rec), offs, cqo, gw=gw, gh=gh)
    for g, w in zip(got, _jax_residual(rec, offs, cqo, gw, gh)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _jax_mc(case, gw, gh):
    """The JAX scan step's MC, residual add, mask and pad
    (``hartallo_tpu/decode/d_gop.py:183-191``)."""
    import jax.numpy as jnp
    from hartallo_tpu.ops.wide import mc_chroma_plane, mc_grids, \
        mc_luma_plane
    stackY, ringU, ringV, mv, slot, wp_l, wp_c, res_y, res_c, inter = \
        (jnp.asarray(a) for a in case)
    bx, by, cbx, cby = mc_grids(gw, gh)
    pY = mc_luma_plane(stackY, slot, bx, by, mv[:, 0], mv[:, 1], wp_l, gw,
                       gh)
    pU = mc_chroma_plane(ringU, slot, cbx, cby, mv[:, 0], mv[:, 1],
                         wp_c[:, 0], gw, gh)
    pV = mc_chroma_plane(ringV, slot, cbx, cby, mv[:, 0], mv[:, 1],
                         wp_c[:, 1], gw, gh)
    my_ = jnp.repeat(jnp.repeat(inter, 16, -2), 16, -1)
    mc_ = jnp.repeat(jnp.repeat(inter, 8, -2), 8, -1)
    return (jnp.pad(jnp.where(my_, jnp.clip(pY + res_y, 0, 255), 0), PAD),
            jnp.pad(jnp.where(mc_, jnp.clip(pU + res_c[0], 0, 255), 0), PAD),
            jnp.pad(jnp.where(mc_, jnp.clip(pV + res_c[1], 0, 255), 0), PAD))


@pytest.mark.parametrize("band", [False, True], ids=["uint8 ring",
                                                     "int32 band stacks"])
def test_mc_twin_equals_jax(band):
    from hartallo_tpu_torch.decode.mc_decode_fast import mc_recon_fast
    gw, gh, S = 4, 3, 3
    case = CS.mc_dec_inputs(gw, gh, S, 40 + band, band=band)
    got = mc_recon_fast(*(torch.tensor(a) for a in case), gw=gw, gh=gh)
    for g, w, name in zip(got, _jax_mc(case, gw, gh), "YUV"):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)


def test_ring_write_twin_equals_jax():
    import jax.numpy as jnp
    from hartallo_tpu.ops.wide import halfpel_planes
    from hartallo_tpu_torch.decode.mc_decode_fast import ring_write_fast
    gw, gh, S = 4, 3, 3
    H, W = gh * 16, gw * 16
    planes, rings, ws, out = CS.ring_write_inputs(gw, gh, S, 50)
    y2, u2, v2 = (p[PAD:-PAD, PAD:-PAD] for p in planes)
    # the JAX step's ring write and output (d_gop.py:208-229)
    uv = jnp.stack([u2, v2], axis=1).reshape(H // 2, W)
    want_out = jnp.concatenate([y2, uv], axis=0).astype(jnp.uint8)
    rY, rU, rV = (jnp.asarray(r) for r in rings)
    hp = halfpel_planes(jnp.pad(jnp.asarray(y2), PAD, mode="edge"))
    hp = jnp.pad(hp, ((0, 0), (0, rY.shape[2] - hp.shape[1]),
                      (0, rY.shape[3] - hp.shape[2])))
    want = [rY.at[ws].set(hp.astype(jnp.uint8))]
    for r, c in ((rU, u2), (rV, v2)):
        cp = jnp.pad(jnp.asarray(c), PAD, mode="edge")
        cp = jnp.pad(cp, ((0, r.shape[1] - cp.shape[0]),
                          (0, r.shape[2] - cp.shape[1])))
        want.append(r.at[ws].set(cp.astype(jnp.uint8)))
    t = [torch.tensor(p) for p in planes]
    tr = [torch.tensor(r) for r in rings]
    to = torch.tensor(out)
    got = ring_write_fast(*(p[PAD:-PAD, PAD:-PAD] for p in t), *tr, ws, to,
                          gw=gw, gh=gh)
    assert got is to
    np.testing.assert_array_equal(to.numpy(), np.asarray(want_out))
    for g, w, name in zip(tr, want, ("ringY", "ringU", "ringV")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)


@pytest.fixture(scope="module")
def redrawn_batch():
    """The 64x48 batch of test_torch_decode_gop.py with its MV words
    redrawn per 4x4 block (a third within 16 quarter pels, a third within
    the pad, a third up to 2,000 quarter pels out), refIdx per 8x8 over
    the ring's S slots, and explicit weights (w and o in -128..127, logWD
    0..7)."""
    from hartallo_tpu_torch.decode.d_gop import _OFF
    jobs, (gw, gh, S, cqoff) = queued_jobs(
        encode_clip(), eligible=lambda sd, wp: "send to the GOP scan")
    packed = np.stack([j.packed for j in jobs]).astype(np.int16)
    K, n, _ = packed.shape
    rng = np.random.default_rng(17)

    def put(name, values):
        o0, o1, _ = _OFF[name]
        packed[:, :, o0:o1] = values.reshape(K, n, o1 - o0)
    reach = rng.choice(np.array([16, 4 * 40, 2000]), (K, n, 16, 2))
    put("mv", rng.integers(-reach, reach + 1))
    put("ref_idx", rng.integers(0, S, (K, n, 4)))
    for name, shape in (("wp_l", (K, n, 4)), ("wp_c", (K, n, 4, 2))):
        put(name, np.stack([rng.integers(-128, 128, shape),
                            rng.integers(-128, 128, shape),
                            rng.integers(0, 8, shape)], -1))
    wslot = np.array([j.wslot for j in jobs], np.int32)
    hintra = np.array([j.has_intra for j in jobs], bool)
    return packed, wslot, hintra, gw, gh, S, cqoff


def test_decode_gop_matches_jax_on_redrawn_motion(redrawn_batch):
    import jax.numpy as jnp
    from hartallo_tpu.decode.d_gop import decode_gop as jax_decode_gop
    from hartallo_tpu_torch.decode.d_gop import decode_gop
    from hartallo_tpu_torch.decode.d_gop_fast import rings_from_numpy
    packed, wslot, hintra, gw, gh, S, cqoff = redrawn_batch
    rings = seeded_rings(gw, gh, S, seed=9)
    want = jax_decode_gop(jnp.asarray(packed), jnp.asarray(wslot),
                          jnp.asarray(hintra),
                          *(jnp.asarray(r) for r in rings),
                          gw=gw, gh=gh, chroma_qp_off=cqoff)
    got = decode_gop(packed, wslot, hintra, *rings_from_numpy(*rings, "cpu"),
                     gw=gw, gh=gh, chroma_qp_off=cqoff)
    for a, b, name in zip(got, want, ("frames", "ringY", "ringU", "ringV")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)


def _ilp_case(gw, gh, seed):
    rng = np.random.default_rng(seed)
    H, W = gh * 16, gw * 16
    refs = [torch.tensor(rng.integers(0, 256, s).astype(np.int32))
            for s in ((H + 64, W + 64), (H // 2 + 64, W // 2 + 64),
                      (H // 2 + 64, W // 2 + 64))]
    mv = torch.tensor(CS.mc_dec_inputs(gw, gh, 1, seed)[3])
    return refs, mv


def test_ilp_predict_equals_the_plain_composition():
    from hartallo_tpu_torch.encode.svc import _ilp_predict
    from hartallo_tpu_torch.ops.wide import (halfpel_planes, mc_chroma_plane,
                                             mc_grids, mc_luma_plane)
    gw, gh = 4, 3
    (refY, refU, refV), mvf = _ilp_case(gw, gh, 60)
    # the composition _ilp_predict ran before it called the kernels'
    # wrappers
    hp = halfpel_planes(refY)[None]
    bx, by, cbx, cby = mc_grids(gw, gh, "cpu")
    n = gh * gw * 16
    slot = torch.zeros((n,), dtype=torch.int32)
    wp = torch.zeros((n, 3), dtype=torch.int32)
    wp[:, 0] = 1
    want = (mc_luma_plane(hp, slot, bx, by, mvf[:, 0], mvf[:, 1], wp, gw,
                          gh),
            *(mc_chroma_plane(c[None], slot, cbx, cby, mvf[:, 0], mvf[:, 1],
                              wp, gw, gh) for c in (refU, refV)))
    got = _ilp_predict(refY, refU, refV, mvf, gw=gw, gh=gh)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _spy(monkeypatch, sites):
    calls = collections.Counter()
    for mod, name in sites:
        real = getattr(mod, name)

        def call(*args, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*args, **kw)
        monkeypatch.setattr(mod, name, call)
    return calls


def test_scan_and_band_step_reach_the_wrappers(monkeypatch, redrawn_batch):
    from hartallo_tpu_torch.decode import d_gop as G
    from hartallo_tpu_torch.decode.d_gop import decode_gop
    from hartallo_tpu_torch.decode.d_gop_fast import rings_from_numpy
    from hartallo_tpu_torch.parallel.shard import (
        Mesh, _split, decode_frame_step_sharded)
    packed, wslot, hintra, gw, gh, S, cqoff = redrawn_batch
    calls = _spy(monkeypatch, [(G, "residual_planes_fast"),
                               (G, "mc_recon_fast"), (G, "ring_write_fast")])
    decode_gop(packed, wslot, hintra,
               *rings_from_numpy(*seeded_rings(gw, gh, S, seed=3), "cpu"),
               gw=gw, gh=gh, chroma_qp_off=cqoff)
    K = len(packed)
    assert dict(calls) == {"residual_planes_fast": 1, "mc_recon_fast": K,
                           "ring_write_fast": K}
    calls.clear()
    mesh = Mesh(("cpu",) * gh)                  # bands of one MB row
    H, W = gh * 16, gw * 16
    rings = [_split(np.zeros((S, h, w), np.int32), mesh, dim=1)
             for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    decode_frame_step_sharded(mesh, packed[0], *rings, int(wslot[0]),
                              gw=gw, gh=gh, chroma_qp_off=cqoff,
                              has_intra=bool(hintra[0]), S=S)
    assert dict(calls) == {"residual_planes_fast": gh, "mc_recon_fast": gh}


# ---------------------------------------------------------------------------
# On the GPU
# ---------------------------------------------------------------------------

# QCIF to 1080p and the band, and the shapes of the emulated tests
# (tests/test_torch_mc_decode_kernel_emulated.py): the MC's strips of four
# MBs that do not divide gw, one MB row or column, the ring write's tile
# rows that end inside the slot or lie in its margin
KERNEL_GRIDS = [("QCIF", 11, 9), ("CIF", 22, 18), ("720p", 80, 45),
                ("1080p", 120, 68), ("band 120x34", 120, 34),
                ("ragged strip 6x4", 6, 4), ("one MB row 9x1", 9, 1),
                ("one MB column 1x5", 1, 5), ("ring tiles 5x1", 5, 1),
                ("ring tiles 7x3", 7, 3), ("band ragged strip 6x2", 6, 2),
                ("band 5x3", 5, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("label,gw,gh", KERNEL_GRIDS,
                         ids=[g[0] for g in KERNEL_GRIDS])
def test_cuda_kernels_equal_twins(cuda_device, label, gw, gh):
    """Each kernel against its twin; the MC on seeded and on coherent
    motion (one MV an MB)."""
    from hartallo_tpu_torch.decode import mc_decode_fast as M
    band = label.startswith("band")
    rec, offs = CS.residual_rec_inputs(gw, gh, 2, gw + gh)
    trec = torch.tensor(rec, device=cuda_device)
    for cqo in (-12, 0, 12):
        got = M.residual_planes_fast(trec, offs, cqo, gw=gw, gh=gh)
        want = M.residual_planes_plain(trec, offs, cqo, gw=gw, gh=gh)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    for coherent in (False, True):
        case = [torch.tensor(a, device=cuda_device)
                for a in CS.mc_dec_inputs(gw, gh, 3, gw * gh, band=band,
                                          coherent=coherent)]
        got = M.mc_recon_fast(*case, gw=gw, gh=gh)
        want = M.mc_recon_plain(*case, gw=gw, gh=gh)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), coherent
    planes, rings, ws, out = CS.ring_write_inputs(gw, gh, 3, gh)
    tp = [torch.tensor(p, device=cuda_device)[PAD:-PAD, PAD:-PAD]
          for p in planes]
    results = []
    for fn in (M.ring_write_fast, M.ring_write_plain):
        tr = [torch.tensor(r, device=cuda_device) for r in rings]
        to = torch.tensor(out, device=cuda_device)
        fn(*tp, *tr, ws, to, gw=gw, gh=gh)
        results.append((*tr, to))
    assert all(torch.equal(g, w) for g, w in zip(*results))


@pytest.fixture
def no_eager_mc(monkeypatch):
    """The eager functions the kernels replace raise on a CUDA tensor."""
    from hartallo_tpu_torch.decode import mc_decode_fast as M
    from hartallo_tpu_torch.encode import p_body_fast as PB
    from hartallo_tpu_torch.ops import wide as OW

    def guard(mod, name):
        real = getattr(mod, name)

        def guarded(*args, **kw):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                raise AssertionError(f"eager {name} ran on the card")
            return real(*args, **kw)
        monkeypatch.setattr(mod, name, guarded)
    for mod in (M, OW):
        for name in ("mc_luma_plane", "mc_chroma_plane",
                     "residual_planes_wide", "halfpel_planes"):
            guard(mod, name)
    guard(PB, "halfpel_planes")
    return guard


def _launches():
    from hartallo_tpu_torch.decode import mc_decode_fast as M
    from hartallo_tpu_torch.encode import p_body_fast as PB
    return {**M.LAUNCHES, "halfpel": PB.LAUNCHES["halfpel"]}


@pytest.mark.cuda
def test_cuda_scan_route_runs_no_eager_mc(cuda_device, no_eager_mc):
    from hartallo_tpu_torch.api import Codec, CodecConfig
    from hartallo_tpu_torch.decode import d_gop as G
    from hartallo_tpu_torch.decode import mc_decode_fast as M
    from hartallo_tpu_torch.ops import wide as OW
    for mod in (G, M, OW):
        if hasattr(mod, "pad_edge"):
            no_eager_mc(mod, "pad_edge")
    stream, meta = load_fixture("qcif_6_wp")
    before = _launches()
    out = Codec(CodecConfig(), device=cuda_device).decode_annexb(
        stream, tolerant=False)
    assert [CS.frame_md5(r.frame) for r in out] == meta["frame_md5"]
    assert {k: v - before[k] for k, v in _launches().items()} == {
        "residual_dec": 1, "mc_dec": 5, "ring_write_dec": 5, "halfpel": 0}


@pytest.mark.cuda
def test_cuda_band_step_runs_no_eager_mc(cuda_device, no_eager_mc):
    from hartallo_tpu_torch.parallel.shard import Mesh, decode_gops_grouped
    stream, meta = load_fixture("shard_96x64_8")
    before = _launches()
    frames = decode_gops_grouped(Mesh(("cuda:0",) * 8), stream, groups=2)
    assert [CS.frame_md5(f) for f in frames] == meta["frame_md5"]
    got = {k: v - before[k] for k, v in _launches().items()}
    n = 4 * meta["frames"]                    # band pictures
    assert got["residual_dec"] == got["mc_dec"] == n
    assert got["ring_write_dec"] == 0


@pytest.mark.cuda
def test_cuda_ilp_predict_runs_no_eager_mc(cuda_device, no_eager_mc):
    from hartallo_tpu_torch.encode.svc import _ilp_predict
    gw, gh = 11, 9
    refs, mvf = _ilp_case(gw, gh, 61)
    want = _ilp_predict(*refs, mvf, gw=gw, gh=gh)
    before = _launches()
    got = _ilp_predict(*(t.to(cuda_device) for t in refs),
                       mvf.to(cuda_device), gw=gw, gh=gh)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    assert {k: v - before[k] for k, v in _launches().items()} == {
        "residual_dec": 0, "mc_dec": 1, "ring_write_dec": 0, "halfpel": 1}
