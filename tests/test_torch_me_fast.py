"""The motion search kernels' wrappers, their plain twins against the JAX
package's ``full_search_int`` and ``refine_subpel``, their routing, and
the CUDA kernels against the twins on a GPU.

- On CPU tensors ``full_search_int_fast`` and ``refine_subpel_fast`` are
  the twins (no launch); they equal the JAX functions on the cases
  ``tests/test_torch_encode_ops.py`` leaves out: ranges 12, 5 and 0, a
  flat source (every candidate ties on SAD), a periodic one, a
  halo-padded reference taller than the source (read with its own row
  stride), both refinement rounds chained on one half-pel stack, random
  partition maps with 1, 4 and 16 partitions, MVs far outside the
  picture, SATD and SAD.  Planes and maps are seeded numpy
  (``_torch_port.me_planes`` / ``me_refine_maps``), 1x2 to 4x3 MBs.
- ``refine_subpel_rounds_fast`` on CPU tensors is the twin's chain
  (half-pel, then quarter-pel on its MVs) and equals the JAX chain.
- ``p_device.p_frame_device`` reaches the wrappers: one full search and
  one call of both refinement rounds per P picture (none with ``refine``
  off), also through ``Codec.encode_frames``; mixed devices and, on the
  card, inputs the kernels do not take raise.
- On a GPU (``cuda``), each kernel equals its twin at CIF and at the
  sharded 1080p step's band of 17 MB rows with its halo reference
  (``chip_smoke.me_inputs``), the two-round launch equals the twin's
  chain, and an encode of the QCIF fixture launches the full search and
  the refinement once each per P picture.

Tolerance: exact equality of every output (the f32 costs included: their
argmins pick the MVs and partitions).
"""
import numpy as np
import pytest
import torch

from _torch_port import (cuda_device, intra_lambda,  # noqa: F401
                         load_fixture, me_planes, me_refine_maps)
from bench import make_clip


def _eq(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.dtype == (torch.float32 if w.dtype == np.float32
                           else torch.int32), i
        assert tuple(g.shape) == w.shape, i
        np.testing.assert_array_equal(g.cpu().numpy(), w,
                                      err_msg=f"output {i}")


# (label, gw, gh, rng, plane kind, extra reference rows, lambda qp)
FS_CASES = [
    ("4x3 range 12, lambda of qp 45", 4, 3, 12, "textured", 0, 45),
    ("2x5 range 5", 2, 5, 5, "textured", 0, 30),
    ("4x3 range 0", 4, 3, 0, "textured", 0, 30),
    ("flat source", 3, 2, 12, "flat", 0, 12),
    ("periodic source", 3, 2, 12, "periodic", 0, 30),
    ("halo reference 16 rows taller, range 24", 2, 2, 24, "textured", 16,
     30),
]


@pytest.mark.parametrize("label,gw,gh,rng,kind,extra,lam_qp", FS_CASES,
                         ids=[c[0] for c in FS_CASES])
def test_cpu_full_search_equals_jax(label, gw, gh, rng, kind, extra,
                                    lam_qp):
    import jax.numpy as jnp

    from hartallo_tpu.encode.me import full_search_int as J
    from hartallo_tpu_torch.encode import me_fast as MF
    src, ref = me_planes(gw, gh, 20 + gw * gh, kind, extra)
    lam = intra_lambda(lam_qp)
    want = J(jnp.asarray(src), jnp.asarray(ref), jnp.float32(lam), gw=gw,
             gh=gh, rng=rng)
    before = MF.FULL_SEARCH_LAUNCHES
    got = MF.full_search_int_fast(torch.tensor(src), torch.tensor(ref),
                                  torch.tensor(lam), gw=gw, gh=gh, rng=rng)
    assert MF.FULL_SEARCH_LAUNCHES == before
    _eq(got, want)
    if kind == "flat":
        # every candidate has SAD 0: the zero MV has the fewest bits
        assert not any(bool(v.any()) for v in got[1::2])


def _jax_refine():
    """The JAX ``refine_subpel`` with ``use_satd`` static as well (its own
    jit traces it, which a Python ``if`` cannot branch on)."""
    import jax

    from hartallo_tpu.encode.me import refine_subpel
    return jax.jit(refine_subpel.__wrapped__,
                   static_argnames=("gw", "gh", "nparts", "use_satd"))


# (label, gw, gh, nparts, use_satd, largest |MV| in quarter-pels, extra
# reference rows)
RF_CASES = [
    ("SATD, 4 partitions", 4, 3, 4, True, 60, 0),
    ("SAD, 4 partitions", 2, 5, 4, False, 60, 0),
    ("SATD, 16 partitions", 3, 2, 16, True, 60, 0),
    ("SAD, 1 partition, MVs far outside", 2, 2, 1, False, 400, 0),
    ("SATD, halo reference 16 rows taller", 2, 2, 4, True, 60, 16),
]


@pytest.mark.parametrize("label,gw,gh,nparts,satd,mv_max,extra", RF_CASES,
                         ids=[c[0] for c in RF_CASES])
def test_cpu_refine_both_rounds_equal_jax(label, gw, gh, nparts, satd,
                                         mv_max, extra):
    """The half-pel round on seeded MVs, then the quarter-pel round on its
    result, both from one half-pel stack, as ``p_frame_device`` chains
    them."""
    import jax.numpy as jnp

    from hartallo_tpu.ops.wide import halfpel_planes as J_hp
    from hartallo_tpu_torch.encode import me_fast as MF
    from hartallo_tpu_torch.ops.wide import halfpel_planes
    J = _jax_refine()
    src, ref = me_planes(gw, gh, 40 + gw * gh, "textured", extra)
    mv, part = me_refine_maps(gw, gh, 50 + nparts, nparts, mv_max)
    lam = intra_lambda(30)
    jhp, hp = J_hp(jnp.asarray(ref)), halfpel_planes(torch.tensor(ref))
    jmv, tmv = jnp.asarray(mv), torch.tensor(mv)
    before = MF.REFINE_LAUNCHES
    for step in (2, 1):
        want = J(jnp.asarray(src), jnp.asarray(ref), jmv, jnp.asarray(part),
                 jnp.float32(lam), step, gw=gw, gh=gh, nparts=nparts,
                 use_satd=satd, hp=jhp)
        got = MF.refine_subpel_fast(torch.tensor(src), torch.tensor(ref),
                                    tmv, torch.tensor(part), lam, step,
                                    gw=gw, gh=gh, nparts=nparts,
                                    use_satd=satd, hp=hp)
        _eq(got, want)
        jmv, tmv = want[0], got[0]
    assert MF.REFINE_LAUNCHES == before


@pytest.mark.parametrize("label,gw,gh,nparts,satd,mv_max,extra", RF_CASES,
                         ids=[c[0] for c in RF_CASES])
def test_cpu_refine_rounds_equal_twin_chain_and_jax(label, gw, gh, nparts,
                                                    satd, mv_max, extra):
    """``refine_subpel_rounds_fast`` with steps (2, 1) on CPU tensors: the
    twin's chain (no launch), and the JAX ``refine_subpel`` chain."""
    import jax.numpy as jnp

    from hartallo_tpu.ops.wide import halfpel_planes as J_hp
    from hartallo_tpu_torch.encode import me as M
    from hartallo_tpu_torch.encode import me_fast as MF
    from hartallo_tpu_torch.ops.wide import halfpel_planes
    J = _jax_refine()
    src, ref = me_planes(gw, gh, 30 + gw * gh, "textured", extra)
    mv, part = me_refine_maps(gw, gh, 70 + nparts, nparts, mv_max)
    lam = intra_lambda(30)
    ts, tr, tp = torch.tensor(src), torch.tensor(ref), torch.tensor(part)
    hp = halfpel_planes(tr)
    jhp, jmv, tmv = J_hp(jnp.asarray(ref)), jnp.asarray(mv), torch.tensor(mv)
    for step in (2, 1):
        jmv, jcost = J(jnp.asarray(src), jnp.asarray(ref), jmv,
                       jnp.asarray(part), jnp.float32(lam), step, gw=gw,
                       gh=gh, nparts=nparts, use_satd=satd, hp=jhp)
        tmv, tcost = M.refine_subpel(ts, tr, tmv, tp, lam, step, gw=gw,
                                     gh=gh, nparts=nparts, use_satd=satd,
                                     hp=hp)
    before = MF.REFINE_LAUNCHES
    got = MF.refine_subpel_rounds_fast(ts, tr, torch.tensor(mv), tp, lam,
                                       (2, 1), gw=gw, gh=gh, nparts=nparts,
                                       use_satd=satd, hp=hp)
    assert MF.REFINE_LAUNCHES == before
    _eq(got, [tmv.numpy(), tcost.numpy()])
    _eq(got, [jmv, jcost])


def test_cpu_refine_computes_its_half_pel_stack():
    """With ``hp`` None the wrapper (as the twin) filters the reference
    itself."""
    import jax.numpy as jnp

    from hartallo_tpu_torch.encode import me_fast as MF
    J = _jax_refine()
    src, ref = me_planes(3, 2, 7, "periodic")
    mv, part = me_refine_maps(3, 2, 8)
    lam = intra_lambda(45)
    want = J(jnp.asarray(src), jnp.asarray(ref), jnp.asarray(mv),
             jnp.asarray(part), jnp.float32(lam), 1, gw=3, gh=2, nparts=4,
             use_satd=True)
    _eq(MF.refine_subpel_fast(torch.tensor(src), torch.tensor(ref),
                              torch.tensor(mv), torch.tensor(part), lam, 1,
                              gw=3, gh=2, nparts=4), want)


def test_devices_must_agree():
    from hartallo_tpu_torch.encode import me_fast as MF
    src, ref = (torch.tensor(p) for p in me_planes(2, 2, 3))
    mv, part = (torch.tensor(a) for a in me_refine_maps(2, 2, 4))
    with pytest.raises(ValueError, match="CUDA device or all on the CPU"):
        MF.full_search_int_fast(src.to("meta"), ref, 1.0, gw=2, gh=2, rng=4)
    with pytest.raises(ValueError, match="CUDA device or all on the CPU"):
        MF.refine_subpel_fast(src, ref, mv.to("meta"), part, 1.0, 2, gw=2,
                              gh=2, nparts=4)


def _count_wrappers(monkeypatch):
    """Count the calls of the two wrappers where ``p_device`` calls them;
    returns the list of (name, steps) of each call."""
    from hartallo_tpu_torch.encode import p_device as PD
    calls = []
    real_fs, real_rf = PD.full_search_int_fast, PD.refine_subpel_rounds_fast

    def fs(*args, **kw):
        calls.append(("full_search", None))
        return real_fs(*args, **kw)

    def rf(*args, **kw):
        calls.append(("refine", tuple(args[5])))
        return real_rf(*args, **kw)
    monkeypatch.setattr(PD, "full_search_int_fast", fs)
    monkeypatch.setattr(PD, "refine_subpel_rounds_fast", rf)
    return calls


@pytest.mark.parametrize("refine", [True, False])
def test_p_frame_device_reaches_the_wrappers(monkeypatch, refine):
    from hartallo_tpu_torch.encode.p_device import p_frame_device
    from hartallo_tpu_torch.ops.wide import pad_edge
    calls = _count_wrappers(monkeypatch)
    gw, gh = 4, 3
    r = np.random.default_rng(5)
    planes = [pad_edge(torch.tensor(r.integers(0, 256, (h, w))
                                    .astype(np.int32)))
              for h, w in [(gh * 16, gw * 16), (gh * 8, gw * 8),
                           (gh * 8, gw * 8)] * 2]
    p_frame_device(*planes, torch.full((gh, gw), 30),
                   torch.tensor(intra_lambda(30)), gw=gw, gh=gh, rng=6,
                   refine=refine, chroma_qp_off=0)
    assert calls == [("full_search", None)] + \
        ([("refine", (2, 1))] if refine else [])


def test_encode_frames_searches_every_p_picture(monkeypatch):
    """An encode of three pictures (one IDR, two P) calls the full search
    once and the refinement once (both rounds) per P picture."""
    from hartallo_tpu_torch.api import Codec, CodecConfig
    calls = _count_wrappers(monkeypatch)
    W, H = 64, 48
    Codec(CodecConfig(width=W, height=H, qp=30, gop_size=3, deblock=True,
                      me_range=8), device="cpu") \
        .encode_frames(make_clip(W, H, 3), W, H)
    assert calls == [("full_search", None), ("refine", (2, 1))] * 2


# chip_smoke.py's ME cases at CIF and the sharded step's band
GPU_CASES = ["CIF", "1080p band of 17 rows, halo reference",
             "CIF range 5, lambda of qp 12"]


@pytest.mark.cuda
@pytest.mark.parametrize("label", GPU_CASES)
def test_cuda_kernels_equal_plain_twins(cuda_device, label):
    import chip_smoke as CS
    from hartallo_tpu_torch.encode import me as M
    from hartallo_tpu_torch.encode import me_fast as MF
    from hartallo_tpu_torch.ops.wide import halfpel_planes
    k, (_, W, H, opts) = next((k, c) for k, c in enumerate(CS.ME_CASES)
                              if c[0] == label)
    gw, gh, c = CS.me_inputs(W, H, CS.SEED + k, **opts)
    src, ref, mv, part = (torch.tensor(c[n], device=cuda_device)
                          for n in ("src", "ref", "mv", "part"))
    lam, rng = torch.tensor(c["lam"], device=cuda_device), c["rng"]
    before = (MF.FULL_SEARCH_LAUNCHES, MF.REFINE_LAUNCHES)
    got = MF.full_search_int_fast(src, ref, lam, gw=gw, gh=gh, rng=rng)
    _eq(got, [w.cpu().numpy() for w in
              M.full_search_int(src, ref, lam, gw=gw, gh=gh, rng=rng)])
    hp = halfpel_planes(ref)
    for step in (2, 1):
        got = MF.refine_subpel_fast(src, ref, mv, part, lam, step, gw=gw,
                                    gh=gh, nparts=4, hp=hp)
        _eq(got, [w.cpu().numpy() for w in M.refine_subpel(
            src, ref, mv, part, lam, step, gw=gw, gh=gh, nparts=4, hp=hp)])
        mv = got[0]
    assert (MF.FULL_SEARCH_LAUNCHES, MF.REFINE_LAUNCHES) == \
        (before[0] + 1, before[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("label", GPU_CASES)
def test_cuda_refine_rounds_equal_twin_chain(cuda_device, label):
    """One launch of both rounds against ``refine_subpel(step 2)`` ->
    ``refine_subpel(step 1)`` on the card."""
    import chip_smoke as CS
    from hartallo_tpu_torch.encode import me as M
    from hartallo_tpu_torch.encode import me_fast as MF
    from hartallo_tpu_torch.ops.wide import halfpel_planes
    k, (_, W, H, opts) = next((k, c) for k, c in enumerate(CS.ME_CASES)
                              if c[0] == label)
    gw, gh, c = CS.me_inputs(W, H, CS.SEED + k, **opts)
    src, ref, mv, part = (torch.tensor(c[n], device=cuda_device)
                          for n in ("src", "ref", "mv", "part"))
    lam = torch.tensor(c["lam"], device=cuda_device)
    hp = halfpel_planes(ref)
    want = (mv, None)
    for step in (2, 1):
        want = M.refine_subpel(src, ref, want[0], part, lam, step, gw=gw,
                               gh=gh, nparts=4, hp=hp)
    before = MF.REFINE_LAUNCHES
    got = MF.refine_subpel_rounds_fast(src, ref, mv, part, lam, (2, 1),
                                       gw=gw, gh=gh, nparts=4, hp=hp)
    assert MF.REFINE_LAUNCHES == before + 1
    _eq(got, [w.cpu().numpy() for w in want])


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    """On the card the wrappers convert nothing: another dtype, a
    non-contiguous map, three steps or a step wider than the kernel's
    window raise before any launch."""
    from hartallo_tpu_torch.encode import me_fast as MF
    src, ref = (torch.tensor(p, device=cuda_device)
                for p in me_planes(2, 2, 3))
    mv, part = (torch.tensor(a, device=cuda_device)
                for a in me_refine_maps(2, 2, 4))
    before = (MF.FULL_SEARCH_LAUNCHES, MF.REFINE_LAUNCHES)
    with pytest.raises(ValueError, match="int32"):
        MF.full_search_int_fast(src.to(torch.int64), ref, 1.0, gw=2, gh=2,
                                rng=4)
    with pytest.raises(ValueError, match="part_of_blk"):
        MF.refine_subpel_rounds_fast(src, ref, mv, part.long(), 1.0, (2, 1),
                                     gw=2, gh=2, nparts=4)
    with pytest.raises(ValueError, match="mv_blk"):
        MF.refine_subpel_rounds_fast(
            src, ref, mv.transpose(0, 1).contiguous().transpose(0, 1), part,
            1.0, (2, 1), gw=2, gh=2, nparts=4)
    with pytest.raises(ValueError, match="one or two"):
        MF.refine_subpel_rounds_fast(src, ref, mv, part, 1.0, (4, 2, 1),
                                     gw=2, gh=2, nparts=4)
    with pytest.raises(ValueError, match="steps up to"):
        MF.refine_subpel_fast(src, ref, mv, part, 1.0, 16, gw=2, gh=2,
                              nparts=4)
    assert (MF.FULL_SEARCH_LAUNCHES, MF.REFINE_LAUNCHES) == before


@pytest.mark.cuda
def test_cuda_encode_launches_per_p_picture(cuda_device):
    from hartallo_tpu_torch.api import Codec, CodecConfig
    from hartallo_tpu_torch.encode import me_fast as MF
    want, meta = load_fixture("qcif_8")
    W, H, NF = meta["width"], meta["height"], meta["frames"]
    codec = Codec(CodecConfig(width=W, height=H, qp=meta["qp"], gop_size=NF,
                              deblock=meta["deblock"],
                              me_range=meta["me_range"]), device=cuda_device)
    before = (MF.FULL_SEARCH_LAUNCHES, MF.REFINE_LAUNCHES)
    res = codec.encode_frames(make_clip(W, H, NF), W, H)
    assert b"".join(r.headers + r.data for r in res) == want
    assert (MF.FULL_SEARCH_LAUNCHES - before[0],
            MF.REFINE_LAUNCHES - before[1]) == (NF - 1, NF - 1)
