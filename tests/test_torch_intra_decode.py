"""The decoder's intra wavefront and deblock parameter kernels: their plain
twins against the JAX package, their wrappers' routing, and the CUDA
kernels against the twins on a GPU.

- The twins: ``decode/intra_recon.intra_reconstruct`` equals the JAX
  package's ``intra_reconstruct`` on ``chip_smoke.intra_dec_inputs``
  (mixed kinds with inter MBs, constrained intra over row slices with the
  above-right flags false on a row); ``ops/deblock_fast
  .deblock_params_dec_plain`` then ``deblock_frame_aux_plain`` equal the
  JAX ``compute_bs`` (I4x4, I16, PCM and I_BL intra) and
  ``deblock_frame_s1`` with the left and top QP maps, on seeded planes
  and ``chip_smoke.deblock_rec_inputs`` records (slice-edge flags,
  per-MB offsets, ``fint`` false on some MBs, edge flags on column 0
  and row 0, chroma QP offsets -3 and 5).
- Routing, on the CPU (where each wrapper runs its twin): the GOP scan
  of ``qcif_6_wp`` calls the parameter and residual wrappers once for
  its batch of 5 pictures, the intra wrapper once (its one scan picture
  with an intra MB) and the MC and ring write wrappers once a scan
  picture (and not the half-pel stack's); the general route of
  ``qcif_6_sl`` the parameter wrapper once a picture and the intra
  wrapper once a picture with an intra MB; each decode keeps its MD5s.
- The wrappers refuse tensors on more than one device.
- On a GPU (``cuda``): each kernel equals its twin at QCIF, CIF and a
  1080p band of 120x34 MBs (the parameters also on 5 pictures a launch
  and in the GOP scan's dense buffer); ``qcif_6_wp``, ``qcif_6_sl``,
  the SVC fixture ``svc_il_4`` and ``shard_1080p_8`` (grouped and
  sharded over four bands of one card) decode to their MD5s with the
  launches their routes need, while the eager twins of the decode
  kernels raise if a CUDA tensor reaches them.

Tolerance: exact equality.
"""
import collections

import numpy as np
import pytest
import torch

import chip_smoke as CS
from _torch_port import cuda_device, load_fixture  # noqa: F401


def _md5s(results):
    return [CS.frame_md5(r.frame) for r in results]


INTRA_JAX_CASES = [
    ("mixed with inter MBs", 4, 3, {"kinds": (0, 1, 3, 8)}),
    ("constrained, slices of 2 rows, tr false on row 1", 3, 5,
     {"kinds": (0, 1, 3), "rows": 2, "constrained": True,
      "tr_false_row": 1}),
]


@pytest.mark.parametrize("label,gw,gh,opts", INTRA_JAX_CASES,
                         ids=[c[0] for c in INTRA_JAX_CASES])
def test_intra_twin_equals_jax(label, gw, gh, opts):
    import jax.numpy as jnp
    from hartallo_tpu.decode.intra_recon import intra_reconstruct as J
    from hartallo_tpu_torch.decode.intra_recon_fast import \
        intra_reconstruct_fast
    case = CS.intra_dec_inputs(gw, gh, 11 * gw + gh, **opts)
    got = intra_reconstruct_fast(
        tuple(torch.tensor(p) for p in case[:3]),
        *(torch.tensor(a) for a in case[3:]), gw=gw, gh=gh)
    want = J(tuple(jnp.asarray(p) for p in case[:3]),
             *(jnp.asarray(a) for a in case[3:]), gw=gw, gh=gh)
    for g, w, name in zip(got, want, "YUV"):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)


@pytest.mark.parametrize("cqo", [-3, 5])
def test_params_twin_deblocks_as_jax(cqo):
    """The twin's rows, through the filter, deblock as the JAX package's
    compute_bs and deblock_frame_s1 do."""
    import jax.numpy as jnp
    from hartallo_tpu.ops.deblock import compute_bs, deblock_frame_s1
    from hartallo_tpu_torch.core.tables import QP_SCALE_CHROMA
    from hartallo_tpu_torch.ops import deblock_fast as D
    gw, gh = 5, 4
    rec, offs = CS.deblock_rec_inputs(gw, gh, 1, 17 + cqo, edge_flags=True)
    planes = CS.deblock_inputs(gw, gh, 5)[0]
    aux = D.deblock_params_dec_fast(torch.tensor(rec), offs, cqo, gw=gw,
                                    gh=gh)
    got = D.deblock_frame_aux_fast(tuple(torch.tensor(p) for p in planes),
                                   aux[0], gw=gw, gh=gh)

    f = {}
    for (name, shape), o in zip(D.DEBLOCK_FIELDS, offs):
        n = int(np.prod(shape, dtype=int)) if shape else 1
        f[name] = rec[0, :, o:o + n].reshape((gh, gw) + shape)
    grid = f["nnz"].transpose(0, 2, 1, 3).reshape(4 * gh, 4 * gw)
    mvg = f["mv"].transpose(0, 2, 1, 3, 4).reshape(4 * gh, 4 * gw, 2)
    refg = f["ref_idx"].reshape(gh, gw, 2, 1, 2, 1).repeat(2, 3) \
        .repeat(2, 5).reshape(gh, gw, 4, 4).transpose(0, 2, 1, 3) \
        .reshape(4 * gh, 4 * gw)
    kind = f["kind"]
    bs_v, bs_h = compute_bs(jnp.asarray((kind <= 2) | (kind == 8)),
                            jnp.asarray(grid), jnp.asarray(mvg),
                            jnp.asarray(refg), jnp.asarray(f["fmb_v"] != 0),
                            jnp.asarray(f["fmb_h"] != 0),
                            jnp.asarray(f["fint"] != 0))
    qp = f["qp"]
    qpc = np.asarray(QP_SCALE_CHROMA)[np.clip(qp + cqo, 0, 51)]

    def left(a):
        return np.concatenate([a[:, :1], a[:, :-1]], axis=1)

    def top(a):
        return np.concatenate([a[:1], a[:-1]], axis=0)
    want = deblock_frame_s1(
        tuple(jnp.asarray(p) for p in planes), bs_v, bs_h,
        *(jnp.asarray(a.astype(np.int32)) for a in (
            qp, left(qp), top(qp), qpc, left(qpc), top(qpc),
            f["alpha_off"], f["beta_off"])), gw=gw, gh=gh)
    for g, w, name in zip(got, want, "YUV"):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)


def _counted(monkeypatch):
    """Count the calls of the decoder's kernel wrappers at their call
    sites."""
    from hartallo_tpu_torch.decode import d_gop as G
    from hartallo_tpu_torch.decode import decoder as DM
    calls = collections.Counter()
    for mod, name in ((G, "intra_reconstruct_fast"),
                      (DM, "intra_reconstruct_fast"),
                      (G, "deblock_params_dec_fast"),
                      (DM, "deblock_params_dec_fast"),
                      (G, "residual_planes_fast"), (G, "mc_recon_fast"),
                      (G, "ring_write_fast"),
                      (DM, "halfpel_planes_fast")):
        real = getattr(mod, name)

        def call(*args, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*args, **kw)
        monkeypatch.setattr(mod, name, call)
    return calls


@pytest.mark.parametrize("fixture,route,want", [
    ("qcif_6_wp", {"kernel_pictures": 1, "scan_pictures": 5,
                   "general_pictures": 0},
     {"intra_reconstruct_fast": 1, "deblock_params_dec_fast": 1,
      "residual_planes_fast": 1, "mc_recon_fast": 5,
      "ring_write_fast": 5}),
    ("qcif_6_sl", {"kernel_pictures": 0, "scan_pictures": 0,
                   "general_pictures": 6},
     {"intra_reconstruct_fast": 2, "deblock_params_dec_fast": 6}),
    ("pcm_64x48", {"kernel_pictures": 0, "scan_pictures": 0,
                   "general_pictures": 1}, {}),
])
def test_decode_routes_reach_the_wrappers(monkeypatch, fixture, route,
                                          want):
    from hartallo_tpu_torch.api import Codec, CodecConfig
    calls = _counted(monkeypatch)
    stream, meta = load_fixture(fixture)
    codec = Codec(CodecConfig(), device="cpu")
    out = codec.decode_annexb(stream, tolerant=False)
    assert _md5s(out) == meta["frame_md5"]
    assert codec.decoder.stats == route
    assert dict(calls) == want


def test_wrappers_refuse_mixed_devices():
    from hartallo_tpu_torch.decode.intra_recon_fast import \
        intra_reconstruct_fast
    case = [None if a is None else torch.tensor(a)
            for a in CS.intra_dec_inputs(2, 2, 1)]
    case[3] = case[3].to("meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        intra_reconstruct_fast(tuple(case[:3]), *case[3:], gw=2, gh=2)


# ---------------------------------------------------------------------------
# On the GPU
# ---------------------------------------------------------------------------

GRIDS = [("QCIF", 11, 9), ("CIF", 22, 18), ("band 120x34", 120, 34)]


@pytest.mark.cuda
@pytest.mark.parametrize("label,gw,gh", GRIDS, ids=[g[0] for g in GRIDS])
def test_cuda_intra_kernel_equals_twin(cuda_device, label, gw, gh):
    from hartallo_tpu_torch.decode import intra_recon_fast as F
    from hartallo_tpu_torch.decode.intra_recon import intra_reconstruct
    for seed, opts in ((1, {}), (2, {"kinds": (0, 1, 3, 8), "rows": 3,
                                     "constrained": True,
                                     "tr_false_row": 1}),
                       (3, {"kinds": (0, 1) + (3,) * 14}),
                       (4, {"kinds": (0,), "layout": "staircase"}),
                       (5, {"kinds": (3, 4, 5)})):
        case = [None if a is None else torch.tensor(a, device=cuda_device)
                for a in CS.intra_dec_inputs(gw, gh, seed, **opts)]
        before = F.LAUNCHES
        got = F.intra_reconstruct_fast(tuple(case[:3]), *case[3:], gw=gw,
                                       gh=gh)
        assert F.LAUNCHES == before + 1
        want = intra_reconstruct(tuple(case[:3]), *case[3:], gw=gw, gh=gh)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("label,gw,gh", GRIDS, ids=[g[0] for g in GRIDS])
def test_cuda_params_kernel_equals_twin(cuda_device, label, gw, gh):
    from hartallo_tpu_torch.ops import deblock_fast as D
    for K, wide in ((1, False), (5, False), (2, True)):
        rec, offs = CS.deblock_rec_inputs(gw, gh, K, K + gw, wide=wide,
                                          edge_flags=True)
        trec = torch.tensor(rec, device=cuda_device)
        before = D.PARAMS_LAUNCHES
        got = D.deblock_params_dec_fast(trec, offs, 2, gw=gw, gh=gh)
        assert D.PARAMS_LAUNCHES == before + 1
        assert torch.equal(got, D.deblock_params_dec_plain(
            trec, offs, 2, gw=gw, gh=gh))


@pytest.fixture
def no_eager_twins(monkeypatch):
    """Make the eager twins of the decode kernels raise when a CUDA tensor
    reaches them: the intra wavefront, the half-pel stack and the deblock
    parameters' bS grids and gather."""
    from hartallo_tpu_torch.decode import intra_recon_fast as F
    from hartallo_tpu_torch.encode import p_body_fast as PB
    from hartallo_tpu_torch.ops import deblock_fast as D
    for mod, name in ((F, "intra_reconstruct"), (PB, "halfpel_planes"),
                      (D, "compute_bs_grids"), (D, "edge_params")):
        real = getattr(mod, name)

        def guarded(*args, _real=real, _name=name, **kw):
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            for a in args:
                if isinstance(a, tuple):
                    tensors += [t for t in a if isinstance(t, torch.Tensor)]
            if any(t.is_cuda for t in tensors):
                raise AssertionError(f"eager {_name} ran on the card")
            return _real(*args, **kw)
        monkeypatch.setattr(mod, name, guarded)


def _launches():
    from hartallo_tpu_torch.decode import intra_recon_fast as F
    from hartallo_tpu_torch.encode import p_body_fast as PB
    from hartallo_tpu_torch.ops import deblock_fast as D
    return {"intra": F.LAUNCHES, "params": D.PARAMS_LAUNCHES,
            "halfpel": PB.LAUNCHES["halfpel"], "deblock": D.LAUNCHES}


def _since(before):
    return {k: v - before[k] for k, v in _launches().items()}


@pytest.mark.cuda
@pytest.mark.parametrize("fixture,want", [
    ("qcif_6_wp", {"intra": 1, "params": 1, "halfpel": 0, "deblock": 5}),
    ("qcif_6_sl", {"intra": 2, "params": 6, "halfpel": 0, "deblock": 6}),
    ("svc_il_4", {"intra": 0, "params": 4, "halfpel": 0, "deblock": 4}),
])
def test_cuda_fixture_launches(cuda_device, no_eager_twins, fixture, want):
    """The GOP scan (qcif_6_wp), the general route (qcif_6_sl, scaling
    lists) and an SVC stream (svc_il_4, whose enhancement pictures take
    the general route) decode to their MD5s with these launches, and no
    eager twin of the decode kernels runs on the card."""
    from hartallo_tpu_torch.api import Codec, CodecConfig
    stream, meta = load_fixture(fixture)
    before = _launches()
    codec = Codec(CodecConfig(), device=cuda_device)
    out = codec.decode_annexb(stream, tolerant=False)
    assert _md5s(out) == meta["frame_md5"]
    assert _since(before) == want


@pytest.mark.cuda
def test_cuda_sharded_decode_fixture(cuda_device, no_eager_twins):
    from hartallo_tpu_torch.parallel.shard import Mesh, decode_gops_grouped
    stream, meta = load_fixture("shard_1080p_8")
    before = _launches()
    frames = decode_gops_grouped(Mesh(("cuda:0",) * 4), stream, groups=2)
    assert [CS.frame_md5(f) for f in frames] == meta["frame_md5"]
    got = _since(before)
    n = 2 * meta["frames"]                     # band pictures
    assert got["params"] == got["deblock"] == n and got["intra"] > 0
    assert got["halfpel"] and got["halfpel"] % n == 0
