"""The P-picture body's kernel wrappers, their plain twins against the JAX
package, their routing, and the CUDA kernels against the twins on a GPU.

- The twins (``p_device.partition_decide``, ``ops/wide.halfpel_planes``,
  ``p_device.p_residual``, ``e_device.deblock_params``), reached through
  the wrappers on CPU tensors (no launch), equal the JAX package's
  ``p_frame_device`` whole: its full search replaced by seeded outputs
  (``_torch_port.fs_case``) whose MVs point up to 100 pels into the pad
  at every edge of the picture and whose partition costs tie, on 4x3 and
  2x5 MBs: the ``bench.make_clip`` pair, a flat source, qp 0..51 per MB,
  qp 0 and 51 with chroma offset +5, ``refine`` off, and a band of the
  sharded step with its halo reference (``chip_smoke.p_inputs``).  Both
  sides share one traced program per grid and static options.
- ``p_frame_fused`` (the JAX ``_p_frame_body``: intra-in-P, the merge, the
  in-loop deblock, the repad and the pack) on a source with flat squares
  pasted into about half of the MBs, some of which go intra.
- The deblock parameters against the JAX ``compute_bs`` and
  ``deblock_pallas._edge_params``: the bS of every edge segment, alpha
  and beta of each edge kind and tc0 by bS.
- Routing: ``encode_frames`` and ``p_encode_step_sharded`` reach each
  wrapper once per P picture (the deblock parameters once per picture or
  band).
- The residual wrapper's one allocation: its six int32 outputs are
  contiguous views of their shapes that tile the allocation, each
  16-byte aligned for the kernel's int4 stores; the partition wrapper's
  four outputs likewise, of three dtypes.
- The deblock parameters' edge flags: the encoder makes its device flags
  once per slice layout, ``e_device._edge_flags`` its default ones once
  per grid and device, and the wrapper takes flags as tensors or numpy.
- On a GPU (``cuda``): each kernel equals its twin on ``chip_smoke``'s
  cases at CIF, qp 51 with an offset, and the 1080p band with its halo;
  the half-pel kernel on planes that its 64 x 16 tiles do not fill,
  contiguous and through a wider row stride; the wrappers refuse what
  the kernels do not take; an encode of the QCIF fixture launches each
  kernel once per P picture.

Tolerance: exact equality of every output.
"""
import numpy as np
import pytest
import torch

import chip_smoke as CS
from _torch_port import (cuda_device, fs_case, load_fixture,  # noqa: F401
                         one_torch_thread, slice_availability)
from bench import make_clip

P_OUT = ("wq", "dcq", "acq", "mv44", "choice", "recY", "recU", "recV",
         "best_cost")


def _eq(got, want, names):
    assert len(got) == len(want)
    for g, w, n in zip(got, want, names):
        w = np.asarray(w.cpu() if isinstance(w, torch.Tensor) else w)
        g = g.cpu().numpy()
        assert g.shape == w.shape, n
        np.testing.assert_array_equal(g, w, err_msg=n)


_JAX_P = {}


def _jax_p_frame(fs, src, ref, qp, lam, *, gw, gh, refine, cqo):
    """The JAX ``p_frame_device`` with its full search replaced by ``fs``,
    jitted once per grid and static options (the seeded search outputs
    are inputs of the traced program)."""
    import jax
    import jax.numpy as jnp
    import hartallo_tpu.encode.p_device as JP
    key = (gw, gh, refine, cqo)
    if key not in _JAX_P:
        def run(fs, src, ref, qp, lam):
            real = JP.full_search_int
            JP.full_search_int = lambda *a, **k: tuple(fs)
            try:
                return JP.p_frame_device.__wrapped__(
                    *src, *ref, qp, lam, gw=gw, gh=gh, rng=12,
                    refine=refine, chroma_qp_off=cqo)
            finally:
                JP.full_search_int = real
        _JAX_P[key] = jax.jit(run)
    j = [jnp.asarray(a) for a in fs]
    return _JAX_P[key](j, [jnp.asarray(p) for p in src],
                       [jnp.asarray(p) for p in ref], jnp.asarray(qp),
                       jnp.float32(lam))


# (label, W, H, options of chip_smoke.p_inputs, seed of fs_case, refine)
CASES = [
    ("4x3 seeded search into the pad, costs that tie", 64, 48, {}, 1,
     True),
    ("4x3 flat source", 64, 48, {"flat": True}, 2, True),
    ("4x3 qp 0..51", 64, 48, {"qp": None}, 3, True),
    ("4x3 band of 3 rows, halo reference", 64, 192, {"band": True}, 4,
     True),
    ("2x5 qp 0, offset +5", 32, 80, {"qp": 0, "cqo": 5}, 5, True),
    ("2x5 qp 51, offset +5", 32, 80, {"qp": 51, "cqo": 5}, 6, True),
    ("2x5 refine off, offset +5", 32, 80, {"cqo": 5}, 7, False),
]


@pytest.mark.parametrize("label,W,H,opts,seed,refine", CASES,
                         ids=[c[0] for c in CASES])
def test_cpu_p_frame_device_on_a_seeded_search_equals_jax(
        monkeypatch, one_torch_thread, label, W, H, opts, seed, refine):
    from hartallo_tpu_torch.encode import p_body_fast as PB
    from hartallo_tpu_torch.encode import p_device as PD
    gw, gh, c = CS.p_inputs(W, H, 40 + seed, **opts)
    fs = fs_case(gw, gh, seed, mv_max=100, tie=True)
    monkeypatch.setattr(PD, "full_search_int_fast",
                        lambda *a, **k: tuple(map(torch.tensor, fs)))
    before = dict(PB.LAUNCHES)
    got = PD.p_frame_device(
        *map(torch.tensor, c["src"] + c["ref"]), torch.tensor(c["qp"]),
        c["lam"], gw=gw, gh=gh, rng=12, refine=refine,
        chroma_qp_off=c["cqo"])
    assert PB.LAUNCHES == before
    want = _jax_p_frame(fs, c["src"], c["ref"], c["qp"], c["lam"], gw=gw,
                        gh=gh, refine=refine, cqo=c["cqo"])
    _eq(got, want, P_OUT)
    # some 4x4 block's prediction lies in the pad beyond each edge
    mv = got[3].numpy() >> 2                     # (gh, gw, 4, 4, 2) pels
    ys, xs = np.meshgrid(np.arange(4 * gh) * 4, np.arange(4 * gw) * 4,
                         indexing="ij")
    y = ys.reshape(gh, 4, gw, 4).transpose(0, 2, 1, 3) + mv[..., 1]
    x = xs.reshape(gh, 4, gw, 4).transpose(0, 2, 1, 3) + mv[..., 0]
    assert y.min() < -4 and y.max() > 16 * gh and x.min() < -4 and \
        x.max() > 16 * gw


def test_cpu_p_frame_fused_intra_heavy_equals_jax(one_torch_thread):
    """The whole P picture body (intra-in-P from the residual's mask, the
    intra merge, the in-loop deblock from the gathered parameters, the
    repad and the pack) on a source where about half the MBs are flat
    squares, against the JAX ``p_frame_fused``."""
    import jax.numpy as jnp

    from hartallo_tpu.encode.e_device import P_FIELDS, unpack
    from hartallo_tpu.encode.e_device import p_frame_fused as J
    from hartallo_tpu_torch.encode.e_device import p_frame_fused as P
    from hartallo_tpu_torch.encode.e_device import pack_src
    W, H = 64, 48
    gw, gh, c = CS.p_inputs(W, H, 8, intra=True)
    src = pack_src(make_clip(W, H, 2)[1], W, H, gw, gh)
    src[:H] = c["src"][0][32:-32, 32:-32]
    uv = np.stack([p[32:-32, 32:-32] for p in c["src"][1:]], axis=1)
    src[H:] = uv.reshape(H // 2, W)
    ref = c["ref"]
    al, at, atr, atl = slice_availability(gw, gh, gh)  # one slice
    kw = dict(gw=gw, gh=gh, rng=12, refine=True, chroma_qp_off=0,
              deblock=True, intra_in_p=True)
    want = J(jnp.asarray(src), *(jnp.asarray(r) for r in ref),
             jnp.asarray(c["qp"]), jnp.float32(c["lam"]), jnp.asarray(al),
             jnp.asarray(at), *(jnp.asarray(m) for m in (al, at, atr, atl)),
             **kw)
    got = P(torch.tensor(src), *map(torch.tensor, ref),
            torch.tensor(c["qp"]), c["lam"], al, at,
            *(torch.tensor(m) for m in (al, at, atr, atl)), **kw)
    _eq(got, want, ("packed", "mad", "Y", "U", "V"))
    is_intra = unpack(np.asarray(want[0]).astype(np.int32), P_FIELDS, gh,
                      gw)["is_intra"]
    assert is_intra.any() and not is_intra.all()


@pytest.mark.parametrize("flags", [False, True])
def test_cpu_deblock_params_equal_jax_bs_and_edge_params(flags):
    """``deblock_params_fast`` on CPU tensors (the twin) against the JAX
    ``compute_bs`` on the grids the JAX ``deblock_recon_device`` builds,
    and ``deblock_pallas._edge_params`` of each edge direction: bS per
    edge segment, alpha / beta of the MB edge and the internal edges (luma
    and chroma), and tc0 per segment by its bS."""
    import jax.numpy as jnp

    from hartallo_tpu.core.tables import LUMA_4x4_BLK_XY, QP_SCALE_CHROMA
    from hartallo_tpu.ops.deblock import compute_bs
    from hartallo_tpu.ops.deblock_pallas import _edge_params
    from hartallo_tpu_torch.encode import p_body_fast as PB
    gw, gh, c = CS.p_inputs(80, 64, 9, qp=None, cqo=3, flags=flags)
    r = np.random.default_rng(10)
    wq = (r.integers(-1, 2, (gh, gw, 16, 4, 4)) *
          (r.random((gh, gw, 16, 1, 1)) < 0.3)).astype(np.int32)
    mv44 = r.integers(-9, 10, (gh, gw, 4, 4, 2)).astype(np.int32)
    ref44 = r.integers(0, 2, (gh, gw, 4, 4)).astype(np.int32)
    intra, qp = c["intra"], c["qp"]
    fv, fh = c["fmb_v"], c["fmb_h"]
    aux = PB.deblock_params_fast(
        *map(torch.tensor, (wq, mv44, ref44, intra, qp)), c["cqo"], fv, fh,
        gw=gw, gh=gh).numpy().astype(np.int32)

    counts = (wq != 0).sum(axis=(-1, -2))
    nnz = np.zeros((4 * gh, 4 * gw), np.int32)
    for blk in range(16):
        bx, by = (int(v) // 4 for v in LUMA_4x4_BLK_XY[blk])
        nnz[by::4, bx::4] = counts[:, :, blk]
    if fv is None:
        fv = np.zeros((gh, gw), bool)
        fv[:, 1:] = True
        fh = np.zeros((gh, gw), bool)
        fh[1:, :] = True
    bs_v, bs_h = (np.asarray(b) for b in compute_bs(
        *map(jnp.asarray, (intra, nnz,
                           mv44.transpose(0, 2, 1, 3, 4).reshape(
                               4 * gh, 4 * gw, 2),
                           ref44.transpose(0, 2, 1, 3).reshape(
                               4 * gh, 4 * gw), fv, fh,
                           np.ones((gh, gw), bool)))))
    np.testing.assert_array_equal(aux[..., 30:46], bs_v.reshape(gh, gw, 16))
    np.testing.assert_array_equal(aux[..., 46:62], bs_h.reshape(gh, gw, 16))

    qpc = QP_SCALE_CHROMA[np.clip(qp + c["cqo"], 0, 51)].astype(np.int32)

    def left_top(a):
        return (np.concatenate([a[:, :1], a[:, :-1]], axis=1),
                np.concatenate([a[:1], a[:-1]], axis=0))
    zeros = jnp.zeros((gh, gw), jnp.int32)
    # (QP map, neighbour QP map, bS, aux columns of alpha/beta at the MB
    # edge and inside, aux column of the MB edge's and the internal tc0)
    for q, nb, bs, ab_e, ab_i, t_e, t_i in (
            (qp, left_top(qp)[0], bs_v, 0, 4, 12, 18),
            (qp, left_top(qp)[1], bs_h, 2, 4, 15, 18),
            (qpc, left_top(qpc)[0], bs_v, 6, 10, 21, 27),
            (qpc, left_top(qpc)[1], bs_h, 8, 10, 24, 27)):
        ab, bs_l, tc0 = (np.asarray(a) for a in _edge_params(
            jnp.asarray((nb + q + 1) >> 1), jnp.asarray(q), zeros, zeros,
            jnp.asarray(bs), jnp.arange(4)))
        np.testing.assert_array_equal(aux[..., ab_e:ab_e + 2], ab[..., 0, :])
        np.testing.assert_array_equal(aux[..., ab_i:ab_i + 2], ab[..., 1, :])
        for e in range(4):
            t3 = aux[..., t_e:t_e + 3] if e == 0 else aux[..., t_i:t_i + 3]
            b = bs_l[:, :, e]
            mine = np.where(b > 0, np.take_along_axis(
                t3, np.clip(b - 1, 0, 2), axis=-1), 0)
            np.testing.assert_array_equal(mine, tc0[:, :, e])


def test_cpu_halfpel_of_a_halo_reference_equals_jax():
    import jax.numpy as jnp

    from hartallo_tpu.ops.wide import halfpel_planes as J
    from hartallo_tpu_torch.encode import p_body_fast as PB
    _, _, c = CS.p_inputs(48, 128, 11, band=True)
    before = dict(PB.LAUNCHES)
    got = PB.halfpel_planes_fast(torch.tensor(c["ref"][0]))
    assert PB.LAUNCHES == before
    _eq([got], [J(jnp.asarray(c["ref"][0]))], ("stack",))


@pytest.mark.parametrize("gw,gh", [(1, 1), (5, 3), (22, 18), (120, 17)])
def test_residual_outputs_tile_one_allocation(gw, gh):
    from hartallo_tpu_torch.encode.p_body_fast import _residual_layout
    total, views = _residual_layout(gw, gh)
    flat = torch.zeros(total, dtype=torch.int32)
    shapes = [(gh, gw, 16, 4, 4), (gh, gw, 2, 2, 2), (gh, gw, 2, 4, 4, 4),
              (gh * 16 + 64, gw * 16 + 64), (gh * 8 + 64, gw * 8 + 64),
              (gh * 8 + 64, gw * 8 + 64)]
    out = [flat.as_strided(*v) for v in views]
    assert [tuple(t.shape) for t in out] == shapes
    assert all(t.is_contiguous() and t.storage_offset() % 4 == 0
               for t in out)
    for k, t in enumerate(out):
        t.fill_(k + 1)
    assert torch.equal(flat, torch.cat([torch.full((t.numel(),), k + 1,
                                                   dtype=torch.int32)
                                        for k, t in enumerate(out)]))


@pytest.mark.parametrize("gw,gh", [(1, 1), (5, 3), (22, 18), (120, 17)])
def test_partition_outputs_tile_one_allocation(gw, gh):
    """The partition wrapper's four outputs: contiguous views of their
    shapes and dtypes that tile one int32 allocation, the int32 maps
    16-byte and choice 8-byte aligned."""
    from hartallo_tpu_torch.encode.p_body_fast import _decide_layout
    words, (v_mv, v_part, v_choice, v_best) = _decide_layout(gw, gh)
    flat = torch.zeros(words, dtype=torch.int32)
    out = [flat.as_strided(*v_mv), flat.as_strided(*v_part),
           flat.view(torch.int64).as_strided(*v_choice),
           flat.view(torch.float32).as_strided(*v_best)]
    assert [(tuple(t.shape), t.dtype) for t in out] == [
        ((gh, gw, 16, 2), torch.int32), ((gh, gw, 16), torch.int32),
        ((gh, gw), torch.int64), ((gh, gw), torch.float32)]
    assert all(t.is_contiguous() for t in out)
    byte_offsets = [t.storage_offset() * t.element_size() for t in out]
    assert byte_offsets[0] % 16 == 0 and byte_offsets[1] % 16 == 0 and \
        byte_offsets[2] % 8 == 0
    for k, t in enumerate(out):
        t.fill_(k + 1)
    n = gw * gh
    assert torch.equal(flat[:32 * n], torch.full((32 * n,), 1,
                                                  dtype=torch.int32))
    assert torch.equal(flat[32 * n:48 * n], torch.full((16 * n,), 2,
                                                        dtype=torch.int32))
    assert torch.equal(flat[48 * n:50 * n].view(torch.int64),
                       torch.full((n,), 3, dtype=torch.int64))
    assert torch.equal(flat[50 * n:51 * n].view(torch.float32),
                       torch.full((n,), 4.0))


def test_encoder_makes_edge_flags_once_per_slice_layout():
    """The encoder's device edge flags equal its numpy masks, and one
    slice layout gives the same tensors on every picture; another layout
    (slice-edge gating, idc 2) gives new ones."""
    from hartallo_tpu_torch.api import CodecConfig
    from hartallo_tpu_torch.encode.encoder import Encoder
    enc = Encoder(CodecConfig(width=64, height=48, deblock=True,
                              deblock_slice_edges=False), device="cpu")
    one = np.zeros((3, 4), np.int32)
    two = np.repeat(np.arange(3, dtype=np.int32)[:, None], 4, 1)
    first = enc._deblock_flags(one)
    assert enc._deblock_flags(one.copy()) is first
    for sid in (one, two):
        got = enc._deblock_flags(sid)
        for g, w in zip(got, enc._deblock_masks(sid)):
            assert g.dtype == torch.bool and np.array_equal(g.numpy(), w)
    assert enc._deblock_flags(two)[1] is not first[1]
    assert not enc._deblock_flags(two)[1][1:].any()


def test_default_edge_flags_are_made_once():
    from hartallo_tpu_torch.encode.e_device import _edge_flags
    fv, fh = _edge_flags(None, None, 4, 3, "cpu")
    assert _edge_flags(None, None, 4, 3, torch.device("cpu"))[0] is fv
    want_v = np.ones((3, 4), bool)
    want_v[:, 0] = False
    want_h = np.ones((3, 4), bool)
    want_h[0] = False
    assert np.array_equal(fv.numpy(), want_v)
    assert np.array_equal(fh.numpy(), want_h)
    mine = np.zeros((3, 4), bool)
    assert not _edge_flags(mine, None, 4, 3, "cpu")[0].any()


def test_deblock_params_take_flags_as_tensors_or_numpy():
    from hartallo_tpu_torch.encode import p_body_fast as PB
    gw, gh, c = CS.p_inputs(64, 48, 21, qp=None, flags=True)
    r = np.random.default_rng(22)
    wq = (r.integers(-1, 2, (gh, gw, 16, 4, 4)) *
          (r.random((gh, gw, 16, 1, 1)) < 0.3)).astype(np.int32)
    args = [torch.tensor(a) for a in (
        wq, r.integers(-9, 10, (gh, gw, 4, 4, 2)).astype(np.int32),
        np.zeros((gh, gw, 4, 4), np.int32), c["intra"], c["qp"])]
    flags = (c["fmb_v"], c["fmb_h"])
    got = PB.deblock_params_fast(*args, 2, *map(torch.tensor, flags),
                                 gw=gw, gh=gh)
    want = PB.deblock_params_fast(*args, 2, *flags, gw=gw, gh=gh)
    assert torch.equal(got, want)


def test_devices_must_agree():
    from hartallo_tpu_torch.encode import p_body_fast as PB
    gw, gh, c = CS.p_inputs(32, 32, 12)
    fs = [torch.tensor(a) for a in fs_case(gw, gh, 13)]
    with pytest.raises(ValueError, match="CUDA device or all on the CPU"):
        PB.partition_decide_fast([fs[0].to("meta"), *fs[1:]], 1.0, gw=gw,
                                 gh=gh)
    planes = [torch.tensor(p) for p in c["src"] + c["ref"]]
    with pytest.raises(ValueError, match="CUDA device or all on the CPU"):
        PB.p_residual_fast(*planes[:5], planes[5].to("meta"),
                           torch.zeros((gh, gw, 16, 2), dtype=torch.int32),
                           torch.tensor(c["qp"]), torch.zeros((gh, gw)),
                           1.0, gw=gw, gh=gh, chroma_qp_off=0,
                           intra_in_p=True)


def _count_wrappers(monkeypatch):
    """Count the calls of the four wrappers where the port calls them."""
    from hartallo_tpu_torch.encode import e_device as E
    from hartallo_tpu_torch.encode import p_device as PD
    calls = []

    def counted(mod, name):
        real = getattr(mod, name)

        def call(*args, **kw):
            calls.append(name)
            return real(*args, **kw)
        monkeypatch.setattr(mod, name, call)
    for name in ("partition_decide_fast", "halfpel_planes_fast",
                 "p_residual_fast"):
        counted(PD, name)
    counted(E, "deblock_params_fast")
    return calls


P_PICTURE = ["partition_decide_fast", "halfpel_planes_fast",
             "p_residual_fast", "deblock_params_fast"]


def test_encode_frames_reaches_each_wrapper_per_p_picture(monkeypatch,
                                                          one_torch_thread):
    """Three pictures (one IDR, two P): the deblock parameters once per
    picture, the other three once per P picture."""
    from hartallo_tpu_torch.api import Codec, CodecConfig
    calls = _count_wrappers(monkeypatch)
    W, H = 64, 48
    Codec(CodecConfig(width=W, height=H, qp=30, gop_size=3, deblock=True,
                      me_range=8), device="cpu") \
        .encode_frames(make_clip(W, H, 3), W, H)
    assert calls == ["deblock_params_fast"] + P_PICTURE * 2


def test_sharded_step_reaches_each_wrapper_per_band(monkeypatch,
                                                    one_torch_thread):
    from hartallo_tpu_torch.parallel.shard import (Mesh,
                                                   p_encode_step_sharded)
    calls = _count_wrappers(monkeypatch)
    gw, gh = 3, 4
    r = np.random.default_rng(14)
    planes = [r.integers(0, 256, s).astype(np.int32) for s in
              [(gh * 16, gw * 16), (gh * 8, gw * 8), (gh * 8, gw * 8)] * 2]
    p_encode_step_sharded(Mesh(("cpu",) * 2), *planes,
                          np.full((gh, gw), 30, np.int32), 20.0, gw=gw,
                          gh=gh, rng=8)
    assert calls == P_PICTURE * 2


# chip_smoke.py's P cases on the card
GPU_CASES = ["CIF", "CIF qp 51, offset +5",
             "1080p band of 17 rows, halo reference",
             "CIF MVs into the pad at every edge", "CIF intra-heavy"]


@pytest.mark.cuda
@pytest.mark.parametrize("label", GPU_CASES)
def test_cuda_kernels_equal_plain_twins(cuda_device, label):
    from hartallo_tpu_torch.encode import p_body_fast as PB
    k = next(k for k, c in enumerate(CS.P_CASES) if c[0] == label)
    before = dict(PB.LAUNCHES)
    out = CS.p_check(torch, *CS.p_case_tensors(torch, k))
    assert all(same for _, same, _, _ in out.values()), \
        {n: err for n, (err, *_) in out.items()}
    assert {n: PB.LAUNCHES[n] - before[n] for n in before} == \
        dict.fromkeys(before, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("hp,wp", [(208, 240), (37, 53), (5, 3), (16, 70)])
def test_cuda_halfpel_of_planes_the_tiles_do_not_fill(cuda_device, hp, wp):
    from hartallo_tpu_torch.encode import p_body_fast as PB
    from hartallo_tpu_torch.ops.wide import halfpel_planes
    plane = np.random.default_rng(hp * 1000 + wp).integers(
        0, 256, (hp, wp)).astype(np.int32)
    want = halfpel_planes(torch.tensor(plane))
    wide = torch.zeros((hp, wp + 7), dtype=torch.int32, device=cuda_device)
    wide[:, 3:3 + wp] = torch.tensor(plane, device=cuda_device)
    for got in (PB.halfpel_planes_fast(wide[:, 3:3 + wp].contiguous()),
                PB.halfpel_planes_fast(wide[:, 3:3 + wp])):
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    """On the card the wrappers convert nothing: another dtype, a
    non-contiguous map or a plane of the wrong size raise before any
    launch."""
    from hartallo_tpu_torch.encode import p_body_fast as PB
    gw, gh, c = CS.p_inputs(64, 48, 15)
    dev = cuda_device
    fs = [torch.tensor(a, device=dev) for a in fs_case(gw, gh, 16)]
    planes = [torch.tensor(p, device=dev) for p in c["src"] + c["ref"]]
    qp = torch.tensor(c["qp"], device=dev)
    mv = torch.zeros((gh, gw, 16, 2), dtype=torch.int32, device=dev)
    best = torch.zeros((gh, gw), device=dev)
    wq = torch.zeros((gh, gw, 16, 4, 4), dtype=torch.int32, device=dev)
    mv44 = torch.zeros((gh, gw, 4, 4, 2), dtype=torch.int32, device=dev)
    ref44 = torch.zeros((gh, gw, 4, 4), dtype=torch.int32, device=dev)
    intra = torch.zeros((gh, gw), dtype=torch.bool, device=dev)
    before = dict(PB.LAUNCHES)
    with pytest.raises(ValueError, match="output 1"):
        PB.partition_decide_fast([fs[0], fs[1].long(), *fs[2:]], 1.0,
                                 gw=gw, gh=gh)
    with pytest.raises(ValueError, match="int32"):
        PB.halfpel_planes_fast(planes[3].float())
    with pytest.raises(ValueError, match="refY"):
        PB.p_residual_fast(*planes[:3], planes[3][:-1], *planes[4:], mv,
                           qp, best, 1.0, gw=gw, gh=gh, chroma_qp_off=0,
                           intra_in_p=True)
    with pytest.raises(ValueError, match="mv_blk"):
        PB.p_residual_fast(*planes, mv.transpose(0, 1).contiguous()
                           .transpose(0, 1), qp, best, 1.0, gw=gw, gh=gh,
                           chroma_qp_off=0, intra_in_p=True)
    with pytest.raises(ValueError, match="mb_is_intra"):
        PB.deblock_params_fast(wq, mv44, ref44, intra.int(), qp, 0, gw=gw,
                               gh=gh)
    with pytest.raises(ValueError, match="qp"):
        PB.deblock_params_fast(wq, mv44, ref44, intra, qp.long(), 0, gw=gw,
                               gh=gh)
    # the levels' int4 and the MVs' int2 loads need aligned starts
    shifted = torch.zeros(wq.numel() + 1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="wq.*16-byte aligned"):
        PB.deblock_params_fast(shifted[1:].view(wq.shape), mv44, ref44,
                               intra, qp, 0, gw=gw, gh=gh)
    with pytest.raises(ValueError, match="output 3.*8-byte aligned"):
        PB.partition_decide_fast(
            [*fs[:3], torch.zeros(fs[3].numel() + 1, dtype=torch.int32,
                                  device=dev)[1:].view(fs[3].shape),
             *fs[4:]], 1.0, gw=gw, gh=gh)
    assert PB.LAUNCHES == before


@pytest.mark.cuda
def test_cuda_encode_launches_per_p_picture(cuda_device):
    from hartallo_tpu_torch.api import Codec, CodecConfig
    from hartallo_tpu_torch.encode import p_body_fast as PB
    want, meta = load_fixture("qcif_8")
    W, H, NF = meta["width"], meta["height"], meta["frames"]
    codec = Codec(CodecConfig(width=W, height=H, qp=meta["qp"], gop_size=NF,
                              deblock=meta["deblock"],
                              me_range=meta["me_range"]), device=cuda_device)
    before = dict(PB.LAUNCHES)
    res = codec.encode_frames(make_clip(W, H, NF), W, H)
    assert b"".join(r.headers + r.data for r in res) == want
    assert {n: PB.LAUNCHES[n] - before[n] for n in before} == {
        "part_decide": NF - 1, "halfpel": NF - 1, "p_residual": NF - 1,
        "deblock_params": NF}
