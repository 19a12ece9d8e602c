"""The encoder's pixel ops in the PyTorch port against the JAX package's.

Forward transforms and quantisers, SATD, 4x4-block MC, whole-frame inter
prediction, boundary strengths, the Exp-Golomb bit count, integer full
search and sub-pel refinement.  Inputs are seeded numpy integers handed
to both sides, at tiny geometry (4x3 and 2x5 MBs).  Tolerance: exact
equality everywhere, the f32 costs of the motion search included (their
argmins pick the modes, so a rounding difference would change the
bitstream).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

PAD = 32
RNG_SEED = 40
LAM = np.float32(np.sqrt(0.85 * 2.0 ** ((30 - 12) / 3.0)))
GEOMETRIES = [(4, 3), (2, 5)]


def _t(a):
    return torch.tensor(np.asarray(a))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# ops/transform.py (forward half) and ops/math.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["forward_dct_4x4", "forward_quant_4x4",
                                  "forward_hadamard_quant_dc_luma",
                                  "forward_hadamard_quant_dc_chroma"])
def test_forward_transform(name):
    from hartallo_tpu.ops import transform as J
    from hartallo_tpu_torch.ops import transform as P
    rng = np.random.default_rng(RNG_SEED)
    qp = rng.integers(0, 52, (6, 52)).astype(np.int32)
    qp[0] = np.arange(52)
    intra = rng.integers(0, 2, (6, 52)).astype(bool)
    if name == "forward_dct_4x4":
        x = rng.integers(-255, 256, (6, 52, 4, 4)).astype(np.int32)
        _eq(P.forward_dct_4x4(_t(x)), J.forward_dct_4x4(x))
    elif name == "forward_quant_4x4":
        w = rng.integers(-4000, 4000, (6, 52, 4, 4)).astype(np.int32)
        for skip_dc in (False, True):
            _eq(P.forward_quant_4x4(_t(w), _t(qp), _t(intra), skip_dc),
                J.forward_quant_4x4(w, qp, intra, skip_dc))
        _eq(P.forward_quant_4x4(_t(w), _t(qp), True),
            J.forward_quant_4x4(w, qp, True))
    elif name == "forward_hadamard_quant_dc_luma":
        c = rng.integers(-4000, 4000, (6, 52, 4, 4)).astype(np.int32)
        _eq(P.forward_hadamard_quant_dc_luma(_t(c), _t(qp)),
            J.forward_hadamard_quant_dc_luma(c, qp))
    else:
        c = rng.integers(-4000, 4000, (6, 52, 2, 2)).astype(np.int32)
        for intra_arg in (_t(intra), False, True):
            want_intra = intra if isinstance(intra_arg, torch.Tensor) \
                else intra_arg
            _eq(P.forward_hadamard_quant_dc_chroma(_t(c), _t(qp), intra_arg),
                J.forward_hadamard_quant_dc_chroma(c, qp, want_intra))


def test_satd4x4():
    from hartallo_tpu.ops.math import satd4x4 as J
    from hartallo_tpu_torch.ops.math import satd4x4 as P
    rng = np.random.default_rng(RNG_SEED + 1)
    a = rng.integers(0, 256, (7, 16, 4, 4)).astype(np.int32)
    b = rng.integers(0, 256, (7, 16, 4, 4)).astype(np.int32)
    _eq(P(_t(a), _t(b)), J(a, b))
    _eq(P(_t(a), _t(b[..., :1, :1])), J(a, b[..., :1, :1]))


# ---------------------------------------------------------------------------
# ops/interpol.py and decode/inter_recon.py
# ---------------------------------------------------------------------------

def _mc_inputs(seed, n, H, W, nref, scale):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 256, (nref, H + 2 * PAD, W + 2 * PAD)) \
        .astype(np.int32)
    bx = rng.integers(0, W // scale, n).astype(np.int32) * scale
    by = rng.integers(0, H // scale, n).astype(np.int32) * scale
    # MVs reaching far into (and past) the pad
    mvx = rng.integers(-4 * (PAD + 8), 4 * (PAD + 8), n).astype(np.int32)
    mvy = rng.integers(-4 * (PAD + 8), 4 * (PAD + 8), n).astype(np.int32)
    sel = rng.integers(-1, nref + 1, n).astype(np.int32)
    return ref, bx, by, mvx, mvy, sel


@pytest.mark.parametrize("name", ["luma_mc_blocks", "chroma_mc_blocks"])
def test_mc_blocks(name):
    from hartallo_tpu.ops import interpol as J
    from hartallo_tpu_torch.ops import interpol as P
    scale = 4 if name == "luma_mc_blocks" else 2
    ref, bx, by, mvx, mvy, sel = _mc_inputs(RNG_SEED + 2, 300, 48, 64, 3,
                                            scale)
    fj, fp = getattr(J, name), getattr(P, name)
    _eq(fp(_t(ref[0]), _t(bx), _t(by), _t(mvx), _t(mvy)),
        fj(jnp.asarray(ref[0]), bx, by, mvx, mvy))
    _eq(fp(_t(ref), _t(bx), _t(by), _t(mvx), _t(mvy), _t(sel)),
        fj(jnp.asarray(ref), bx, by, mvx, mvy, sel))


@pytest.mark.parametrize("gw,gh", GEOMETRIES)
def test_inter_predict_frame(gw, gh):
    from hartallo_tpu.decode import inter_recon as J
    from hartallo_tpu_torch.decode import inter_recon as P
    rng = np.random.default_rng(RNG_SEED + gw)
    H, W = gh * 16, gw * 16
    refs = [rng.integers(0, 256, (2, h + 2 * PAD, w + 2 * PAD))
            .astype(np.int32) for h, w in ((H, W), (H // 2, W // 2),
                                           (H // 2, W // 2))]
    mv = rng.integers(-150, 150, (gh, gw, 4, 4, 2)).astype(np.int32)
    ref_idx = rng.integers(0, 2, (gh, gw, 4)).astype(np.int32)
    want = J.inter_predict_frame(*(jnp.asarray(r) for r in refs), mv,
                                 ref_idx, gw, gh)
    got = P.inter_predict_frame(*(_t(r) for r in refs), _t(mv), _t(ref_idx),
                                gw, gh)
    for g, w in zip(got, want):
        _eq(g, w)
    plane = rng.integers(0, 256, (H, W)).astype(np.int32)
    _eq(P.plane_to_mbs(_t(plane), 16), J.plane_to_mbs(plane, 16))
    mbs = np.asarray(J.plane_to_mbs(plane, 8))
    _eq(P.mbs_to_plane(_t(mbs)), J.mbs_to_plane(mbs))


# ---------------------------------------------------------------------------
# ops/deblock.compute_bs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gw,gh", GEOMETRIES)
def test_compute_bs(gw, gh):
    from hartallo_tpu.ops.deblock import compute_bs as J
    from hartallo_tpu_torch.ops.deblock import compute_bs as P
    rng = np.random.default_rng(RNG_SEED + 10 * gw + gh)
    args = (rng.integers(0, 2, (gh, gw)).astype(bool),
            rng.integers(0, 3, (4 * gh, 4 * gw)).astype(np.int32) *
            rng.integers(0, 2, (4 * gh, 4 * gw)).astype(np.int32),
            rng.integers(-6, 7, (4 * gh, 4 * gw, 2)).astype(np.int32),
            rng.integers(0, 2, (4 * gh, 4 * gw)).astype(np.int32),
            rng.integers(0, 2, (gh, gw)).astype(bool),
            rng.integers(0, 2, (gh, gw)).astype(bool),
            rng.integers(0, 2, (gh, gw)).astype(bool))
    want = J(*(jnp.asarray(a) for a in args))
    got = P(*(_t(a) for a in args))
    for g, w in zip(got, want):
        _eq(g, w)


# ---------------------------------------------------------------------------
# encode/me.py
# ---------------------------------------------------------------------------

def test_se_bits_over_every_search_mv():
    """Every MV component the searches produce: full search (4 x offsets
    up to the largest range, PAD - 8 = 24) and the refinement rounds
    (quarter-pel MVs up to 4 * 24 + 3) with a wide margin, plus the
    powers of two and their neighbours up to 2^16.  (From about 2^18 on,
    the JAX package's f32 log2 rounds log2(2^k - 1) up to k; no search
    comes near such MVs.)"""
    from hartallo_tpu.encode.me import _se_bits as J
    from hartallo_tpu_torch.encode.me import _se_bits as P
    p2 = np.int64(1) << np.arange(17)
    v = np.concatenate([np.arange(-4096, 4097), p2, -p2, p2 - 1, 1 - p2]) \
        .astype(np.int32)
    _eq(P(_t(v)), J(jnp.asarray(v)))


def _me_planes(gw, gh, seed):
    """A textured reference and a shifted, noisy source (both padded)."""
    rng = np.random.default_rng(seed)
    H, W = gh * 16, gw * 16
    y, x = np.mgrid[:H + 2 * PAD, :W + 2 * PAD]
    ref = ((x * 3 + y * 5) % 256 + rng.integers(0, 40, x.shape)) % 256
    src = np.clip(np.roll(ref, (2, -3), (0, 1)) +
                  rng.integers(-3, 4, ref.shape), 0, 255)
    return src.astype(np.int32), ref.astype(np.int32)


@pytest.mark.parametrize("gw,gh,rng_", [(4, 3, 12), (2, 5, 5)])
def test_full_search_int(gw, gh, rng_):
    from hartallo_tpu.encode.me import full_search_int as J
    from hartallo_tpu_torch.encode.me import full_search_int as P
    src, ref = _me_planes(gw, gh, RNG_SEED + 20 + gw)
    want = J(jnp.asarray(src), jnp.asarray(ref), jnp.float32(LAM), gw=gw,
             gh=gh, rng=rng_)
    got = P(_t(src), _t(ref), LAM, gw=gw, gh=gh, rng=rng_)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.dtype == (torch.float32 if np.asarray(w).dtype == np.float32
                           else torch.int32)
        _eq(g, w)


@pytest.mark.parametrize("step", [2, 1])
def test_refine_subpel(step):
    from hartallo_tpu.encode.me import refine_subpel as J
    from hartallo_tpu_torch.encode.me import refine_subpel as P
    gw, gh = 4, 3
    src, ref = _me_planes(gw, gh, RNG_SEED + 30)
    rng = np.random.default_rng(RNG_SEED + 31)
    mv_blk = rng.integers(-60, 60, (gh, gw, 16, 2)).astype(np.int32)
    part = rng.integers(0, 4, (gh, gw, 16)).astype(np.int32)
    want = J(jnp.asarray(src), jnp.asarray(ref), jnp.asarray(mv_blk),
             jnp.asarray(part), jnp.float32(LAM), step, gw=gw, gh=gh,
             nparts=4)
    got = P(_t(src), _t(ref), _t(mv_blk), _t(part), LAM, step, gw=gw, gh=gh,
            nparts=4)
    for g, w in zip(got, want):
        _eq(g, w)
