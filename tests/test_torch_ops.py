"""The port's pixel ops (``hartallo_tpu_torch.ops``) and its copy of
``d_pool`` against the JAX package's functions.

Inputs are seeded numpy integers handed to both sides.  Tolerance: exact
equality everywhere, since this is an integer codec.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hartallo_tpu.core.tables import QP_SCALE_CHROMA

RNG_SEED = 20


def _t(a):
    return torch.tensor(np.asarray(a))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ---------------------------------------------------------------------------
# ops/transform.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["dequant_4x4", "inverse_transform_4x4",
                                  "luma_dc_descale_intra16",
                                  "chroma_dc_descale"])
def test_transform(name):
    from hartallo_tpu.ops import transform as J
    from hartallo_tpu_torch.ops import transform as P
    rng = np.random.default_rng(RNG_SEED)
    qp = rng.integers(0, 52, (6, 52)).astype(np.int32)
    qp[0] = np.arange(52)
    if name == "chroma_dc_descale":
        c = rng.integers(-300, 300, (6, 52, 2, 2)).astype(np.int32)
    else:
        c = rng.integers(-300, 300, (6, 52, 4, 4)).astype(np.int32)
    if name == "inverse_transform_4x4":
        c = c * 40
        _eq(P.inverse_transform_4x4(_t(c)), J.inverse_transform_4x4(c))
    else:
        _eq(getattr(P, name)(_t(c), _t(qp)), getattr(J, name)(c, qp))


# ---------------------------------------------------------------------------
# ops/wavefront.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slope", [1, 2])
def test_wavefront(slope):
    from hartallo_tpu.ops import wavefront as J
    from hartallo_tpu_torch.ops import wavefront as P
    gw, gh = 5, 3
    gj = (J.skew1_geometry if slope == 1 else J.skew_geometry)(gw, gh)
    gp = (P.skew1_geometry if slope == 1 else P.skew_geometry)(gw, gh)
    for k in gj:
        _eq(gp[k], gj[k])
    rng = np.random.default_rng(RNG_SEED + slope)
    plane = rng.integers(0, 256, (gh * 16, gw * 16)).astype(np.int32)
    tj = J.plane_to_tiles(jnp.asarray(plane), 16)
    tp = P.plane_to_tiles(_t(plane), 16)
    _eq(tp, tj)
    sj, sp = J.skew(tj, gj), P.skew(tp, gp)
    _eq(sp, sj)
    _eq(P.unskew(sp, gp), J.unskew(sj, gj))
    _eq(P.tiles_to_plane(tp), J.tiles_to_plane(tj))
    _eq(P.shift_k(sp[0], 7), J.shift_k(sj[0], 7))
    _eq(P.unshift_k(sp[0]), J.unshift_k(sj[0]))


# ---------------------------------------------------------------------------
# ops/wide.py
# ---------------------------------------------------------------------------

def test_halfpel_planes_and_qpt():
    from hartallo_tpu.ops import wide as J
    from hartallo_tpu_torch.ops import wide as P
    rng = np.random.default_rng(RNG_SEED)
    G = rng.integers(0, 256, (48 + 64, 64 + 64)).astype(np.int32)
    _eq(P.halfpel_planes(_t(G)), J.halfpel_planes(jnp.asarray(G)))
    _eq(P._QPT, J._QPT)
    for a, b in zip(P.mc_grids(4, 3, "cpu"), J.mc_grids(4, 3)):
        _eq(a, b)


def _mc_inputs(rng, gw, gh, S, chroma):
    N = gh * gw * 16
    slot = rng.integers(0, S, N).astype(np.int32)
    rngmv = 160 if not chroma else 200
    mvx = rng.integers(-rngmv, rngmv, N).astype(np.int32)
    mvy = rng.integers(-rngmv, rngmv, N).astype(np.int32)
    wp3 = np.stack([rng.integers(-3, 9, N), rng.integers(-9, 9, N),
                    rng.integers(0, 4, N)], axis=1).astype(np.int32)
    return slot, mvx, mvy, wp3


@pytest.mark.parametrize("plane", ["luma", "chroma"])
def test_mc_planes(plane):
    from hartallo_tpu.ops import wide as J
    from hartallo_tpu_torch.ops import wide as P
    rng = np.random.default_rng(RNG_SEED + 3)
    gw, gh, S = 4, 3, 3
    bx, by, cbx, cby = J.mc_grids(gw, gh)
    slot, mvx, mvy, wp3 = _mc_inputs(rng, gw, gh, S, plane == "chroma")
    if plane == "luma":
        ring = rng.integers(0, 256, (S, 4, gh * 16 + 96, gw * 16 + 200),
                            dtype=np.uint8)
        fj, fp, x, y = J.mc_luma_plane, P.mc_luma_plane, bx, by
    else:
        ring = rng.integers(0, 256, (S, gh * 8 + 96, gw * 8 + 200),
                            dtype=np.uint8)
        fj, fp, x, y = J.mc_chroma_plane, P.mc_chroma_plane, cbx, cby
    want = fj(jnp.asarray(ring), jnp.asarray(slot), x, y, jnp.asarray(mvx),
              jnp.asarray(mvy), jnp.asarray(wp3), gw, gh)
    got = fp(_t(ring), _t(slot), _t(x), _t(y), _t(mvx), _t(mvy), _t(wp3),
             gw, gh)
    _eq(got, want)


def test_residual_planes_wide():
    from hartallo_tpu.ops import wide as J
    from hartallo_tpu_torch.ops import wide as P
    rng = np.random.default_rng(RNG_SEED + 4)
    gw, gh, B = 3, 2, 2
    M = B * gw * gh
    args = (rng.integers(-40, 40, (M, 16, 16)).astype(np.int32),
            rng.integers(-40, 40, (M, 16)).astype(np.int32),
            rng.integers(-40, 40, (M, 2, 4, 16)).astype(np.int32),
            rng.integers(-40, 40, (M, 2, 4)).astype(np.int32),
            rng.integers(0, 52, M).astype(np.int32),
            rng.random(M) < 0.5)
    qpc = QP_SCALE_CHROMA.astype(np.int32)
    wy, wc = J.residual_planes_wide(*(jnp.asarray(a) for a in args), 2,
                                    jnp.asarray(qpc), gw, gh)
    py, pc = P.residual_planes_wide(*(_t(a) for a in args), 2, _t(qpc),
                                    gw, gh)
    _eq(py, wy)
    _eq(pc, wc)


def test_compute_bs_grids():
    from hartallo_tpu.ops import wide as J
    from hartallo_tpu_torch.ops import wide as P
    rng = np.random.default_rng(RNG_SEED + 5)
    K, gw, gh = 2, 4, 3
    args = (rng.random((K, gh, gw)) < 0.2,
            rng.integers(0, 3, (K, 4 * gh, 4 * gw)).astype(np.int32),
            rng.integers(-9, 9, (K, 4 * gh, 4 * gw, 2)).astype(np.int32),
            rng.integers(0, 2, (K, 4 * gh, 4 * gw)).astype(np.int32),
            rng.random((K, gh, gw)) < 0.8, rng.random((K, gh, gw)) < 0.8,
            rng.random((K, gh, gw)) < 0.8)
    for a, b in zip(P.compute_bs_grids(*(_t(a) for a in args)),
                    J.compute_bs_grids(*(jnp.asarray(a) for a in args))):
        _eq(a, b)


# ---------------------------------------------------------------------------
# ops/intra.py
# ---------------------------------------------------------------------------

def test_intra_tables():
    from hartallo_tpu.ops import intra as J
    from hartallo_tpu_torch.ops import intra as P
    for name in ("_IDX", "_WGT", "_RND", "_SHT"):
        _eq(getattr(P, name), getattr(J, name))
    assert P.GATHER_MODES == J.GATHER_MODES


@pytest.mark.parametrize("bank,n_top,n_left",
                         [("pred4x4_all", 8, 4), ("pred16x16_all", 16, 16),
                          ("pred_chroma_all", 8, 8)])
def test_intra_banks(bank, n_top, n_left):
    from hartallo_tpu.ops import intra as J
    from hartallo_tpu_torch.ops import intra as P
    rng = np.random.default_rng(RNG_SEED + n_top + n_left)
    B = 64
    top = rng.integers(0, 256, (B, n_top)).astype(np.int32)
    left = rng.integers(0, 256, (B, n_left)).astype(np.int32)
    tl = rng.integers(0, 256, B).astype(np.int32)
    at = np.arange(B) % 2 == 0
    al = (np.arange(B) // 2) % 2 == 0
    want = getattr(J, bank)(jnp.asarray(top), jnp.asarray(left),
                            jnp.asarray(tl), jnp.asarray(at), jnp.asarray(al))
    got = getattr(P, bank)(_t(top), _t(left), _t(tl), _t(at), _t(al))
    _eq(got, want)


# ---------------------------------------------------------------------------
# ops/deblock.py
# ---------------------------------------------------------------------------

def _deblock_inputs(rng, gw, gh):
    H, W = gh * 16, gw * 16
    base = rng.integers(60, 120, (H + 64, W + 64))
    planes = [np.clip(base + rng.integers(-6, 7, base.shape), 0, 255),
              rng.integers(90, 110, (H // 2 + 64, W // 2 + 64)),
              rng.integers(140, 160, (H // 2 + 64, W // 2 + 64))]
    planes = [p.astype(np.int32) for p in planes]
    bs_v = rng.integers(0, 5, (gh, gw, 4, 4)).astype(np.int32)
    bs_h = rng.integers(0, 5, (gh, gw, 4, 4)).astype(np.int32)
    bs_v[:, 0, 0] = 0                                   # picture edges
    bs_h[0, :, 0] = 0
    qp = rng.integers(20, 45, (gh, gw)).astype(np.int32)
    qp_l = np.concatenate([qp[:, :1], qp[:, :-1]], axis=1)
    qp_t = np.concatenate([qp[:1], qp[:-1]], axis=0)
    qpc = QP_SCALE_CHROMA[qp].astype(np.int32)
    qpc_l = np.concatenate([qpc[:, :1], qpc[:, :-1]], axis=1)
    qpc_t = np.concatenate([qpc[:1], qpc[:-1]], axis=0)
    offa = rng.integers(-3, 4, (gh, gw)).astype(np.int32) * 2
    offb = rng.integers(-3, 4, (gh, gw)).astype(np.int32) * 2
    return planes, (bs_v, bs_h, qp, qp_l, qp_t, qpc, qpc_l, qpc_t, offa,
                    offb)


@pytest.mark.parametrize("gw,gh", [(4, 3), (2, 5)])
def test_deblock_frame_s1(gw, gh):
    from hartallo_tpu.ops.deblock import deblock_frame_s1 as J
    from hartallo_tpu_torch.ops.deblock import deblock_frame_s1 as P
    planes, rest = _deblock_inputs(np.random.default_rng(gw * 10 + gh),
                                   gw, gh)
    want = J(tuple(jnp.asarray(p) for p in planes),
             *(jnp.asarray(a) for a in rest), gw=gw, gh=gh)
    got = P(tuple(_t(p) for p in planes), *(_t(a) for a in rest),
            gw=gw, gh=gh)
    for a, b in zip(got, want):
        _eq(a, b)
    assert any(not np.array_equal(np.asarray(b), p)
               for b, p in zip(want, planes))            # it filtered


# ---------------------------------------------------------------------------
# decode/d_pool.py (the port's copy) == hartallo_tpu.decode.d_pool
# ---------------------------------------------------------------------------

def _slice_data(rng, gw, gh):
    from test_decode_pallas import _rand_slice_data
    sd = _rand_slice_data(gw, gh, rng, density=0.3)
    kind = sd.mb_kind
    kind[rng.random((gh, gw)) < 0.25] = 0              # Intra4x4
    kind[rng.random((gh, gw)) < 0.15] = 1              # Intra16x16
    sd.i4_modes[:] = rng.integers(0, 9, sd.i4_modes.shape)
    sd.i16_mode[:] = rng.integers(0, 4, sd.i16_mode.shape)
    sd.chroma_mode[:] = rng.integers(0, 4, sd.chroma_mode.shape)
    sd.luma_dc[:] = rng.integers(-20, 20, sd.luma_dc.shape)
    mv8 = rng.integers(-40, 40, (gh, gw, 2, 2, 2))
    sd.mv[:] = np.repeat(np.repeat(mv8, 2, 2), 2, 3)
    sd.mv[kind <= 1] = 0
    sd.alpha_off[:] = rng.integers(-3, 4, (gh, gw)) * 2
    return sd


def test_d_pool_copy_matches():
    """The port's eligible agrees with the JAX package's on every rule but
    the intra count: the port has no intra-list capacity (the Pallas
    kernel's ``nimax``), so a picture that only overflows it is eligible
    in the port and refused by the JAX package."""
    from hartallo_tpu.decode import d_pool as J
    from hartallo_tpu_torch.decode import d_pool as P
    _eq(P._QPT_NP, J._QPT_NP)
    assert not hasattr(P, "nimax") and not hasattr(P, "nrmax")
    rng = np.random.default_rng(RNG_SEED + 6)
    gw, gh = 5, 4
    for trial in range(3):
        sd = _slice_data(rng, gw, gh)
        if trial == 2:                                 # sub-8x8 motion
            sd.mv[0, 0, 0, 1, 0] += 4
        assert P.eligible(sd, None) == J.eligible(sd, None)
        assert P.eligible(sd, np.ones(1)) == J.eligible(sd, np.ones(1))
        f = np.ones((gh, gw), bool)
        f[:, 0] = False
        al = rng.random((gh, gw)) < 0.7
        at = rng.random((gh, gw)) < 0.7
        atr = rng.random((gh, gw)) < 0.7
        a = P.pack_fast(sd, f, f, f, 1, 2,
                        al=al, at=at, atr=atr)
        b = J.pack_fast(sd, f, f, f, 1, 2, al=al, at=at, atr=atr)
        for field in ("smb", "aux", "tags", "vals", "counts", "ilist",
                      "ivals"):
            _eq(getattr(a, field), getattr(b, field))
        assert (a.wslot, a.ref_slot) == (b.wslot, b.ref_slot)
    # an all-intra 24x22 picture: 528 intra MBs, over the Pallas list's 512
    big = _slice_data(rng, 24, 22)
    big.mb_kind[:] = 0
    big.mv[:] = 0
    big.ref_idx[:] = 0
    assert J.eligible(big, None) == \
        "too many intra macroblocks for the SMEM list"
    assert P.eligible(big, None) is None


def test_edge_params_match_d_pool_aux():
    """ops/deblock.edge_params (from the bS grids and QP maps) lays out
    exactly what d_pool's host aux holds."""
    from hartallo_tpu.decode import d_pool as J
    from hartallo_tpu_torch.ops.deblock import edge_params
    rng = np.random.default_rng(RNG_SEED + 7)
    gw, gh, cq = 5, 4, 3
    sd = _slice_data(rng, gw, gh)
    fv = np.ones((gh, gw), bool)
    fv[:, 0] = False
    fh = np.ones((gh, gw), bool)
    fh[0] = False
    fi = rng.random((gh, gw)) < 0.9
    bs_vg, bs_hg = J._bs_grids_np(sd, fv, fh, fi)
    bs_v = bs_vg.reshape(gh, 4, gw, 4).transpose(0, 2, 3, 1)
    bs_h = bs_hg.reshape(gh, 4, gw, 4).transpose(0, 2, 1, 3)
    qp = sd.qp.astype(np.int32)
    qpc = QP_SCALE_CHROMA[np.clip(qp + cq, 0, 51)].astype(np.int32)

    def lt(a):
        return (np.concatenate([a[:, :1], a[:, :-1]], axis=1),
                np.concatenate([a[:1], a[:-1]], axis=0))
    got = edge_params(_t(bs_v), _t(bs_h), _t(qp), *map(_t, lt(qp)), _t(qpc),
                      *map(_t, lt(qpc)), _t(sd.alpha_off.astype(np.int32)),
                      _t(sd.beta_off.astype(np.int32)))
    _eq(got, J._aux_np(sd, fv, fh, fi, cq).astype(np.int32))
