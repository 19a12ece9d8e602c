"""The GOP kernel's payload built by the native pass (``native/packc.c``
through ``d_pool.pack_fast``) against its numpy oracle
``d_pool.pack_fast_py`` and the JAX package's ``d_pool.pack_fast``.

- One case per kind of picture: seeded ``SliceData`` (all-intra IDR with
  Intra16x16 and Intra4x4 MBs; P pictures with 16x16, 16x8, 8x16 and
  quadrant-uniform 8x8 MBs and a share of intra MBs; MVs that clamp at
  every picture edge; three slices with disable_deblocking_filter_idc 0,
  1 and 2 and nonzero alpha/beta offsets; chroma_qp_index_offset -12 and
  +12; the intra availability masks given and None; CIF, 720p and
  120x68 MBs; an MV a 4x4 block, MVs near one another so that the bS
  rule's |dMV| >= 4 falls both ways, and filter flags drawn at random,
  the picture's edges included), each with QPs spread over 0-51.  Every field of the
  ``FastFrame`` is equal bit for bit, dtype and shape included, to the
  oracle's, and to the JAX package's wherever that package's own
  ``eligible`` takes the picture (its intra-list capacity refuses large
  all-intra pictures).
- Pictures whose levels push an inter or an intra residual past
  ``MAX_RES``: the native pass, the oracle and the JAX package all raise
  OverflowError; an intra residual that wraps into range as int16 (the
  guard reads the stored pool) raises on none.
- A decode through ``Decoder(device="cpu")`` of fixtures whose pictures
  take the kernel route: the frames are the recorded ones with the
  native pass and with ``pack_fast_py`` in its place, and the counter
  ``decode.pack_native`` advances by the decoder's kernel pictures.
"""
import numpy as np
import pytest

from _torch_port import load_fixture
from hartallo_tpu_torch import tracing
from hartallo_tpu_torch.decode import d_pool as P
from hartallo_tpu_torch.decode.decoder import Decoder
from hartallo_tpu_torch.decode.slice_decode import SliceData
from hartallo_tpu_torch.native import pack as native_pack
from hartallo_tpu_torch.util.checks import plane_md5

FIELDS = ("smb", "aux", "tags", "vals", "counts", "ilist", "ivals")

pytestmark = pytest.mark.skipif(not native_pack.available(),
                                reason="the native payload pass needs gcc")


def _picture(rng, gw, gh, *, intra=0.15, idr=False, slices=((0, 0, 0),),
             clamp=False, sub8x8=False, mv_range=60):
    """A seeded picture as the parse and ``derive_mvs`` leave it: P MBs of
    every partition with one MV an 8x8 quadrant, ``intra`` of them
    Intra4x4 or Intra16x16 (all with ``idr``); sparse levels and their
    TotalCoeff maps; QPs over 0-51; ``slices`` as (idc, alpha, beta)
    bands of MB rows; with ``clamp`` the edge MBs' MVs point far out of
    the picture; with ``sub8x8`` the P_8x8 MBs have an MV a 4x4 block (a
    picture ``eligible`` refuses, which ``pack_fast_py`` packs all the
    same).  MV components lie in [-mv_range, mv_range)."""
    sd = SliceData.create(gw, gh)
    if idr:
        kind = rng.integers(0, 2, (gh, gw))
    else:
        kind = rng.integers(3, 8, (gh, gw))
        kind[rng.random((gh, gw)) < intra] = 0
        kind[rng.random((gh, gw)) < intra / 2] = 1
    sd.mb_kind[:] = kind
    sd.qp[:] = rng.integers(0, 52, (gh, gw))
    sd.i16_mode[:] = rng.integers(-1, 5, (gh, gw))
    sd.chroma_mode[:] = rng.integers(-1, 5, (gh, gw))
    sd.i4_modes[:] = rng.integers(-1, 10, (gh, gw, 16))

    mv = rng.integers(-mv_range, mv_range, (gh, gw, 2, 2, 2))  # quadrants
    k = kind[..., None, None, None]
    mv = np.where((k == 3) | (k == 4), mv[:, :, :1, :1], mv)   # 16x16
    mv = np.where(k == 5, mv[:, :, :, :1], mv)                 # 16x8
    mv = np.where(k == 6, mv[:, :, :1, :], mv)                 # 8x16
    if clamp:
        far = 4 * 16 * 6 + 1
        mv[:, 0, ..., 0] = -far - rng.integers(0, 4, (gh, 2, 2))
        mv[:, -1, ..., 0] = far + rng.integers(0, 4, (gh, 2, 2))
        mv[0, :, ..., 1] = -far - rng.integers(0, 4, (gw, 2, 2))
        mv[-1, :, ..., 1] = far + rng.integers(0, 4, (gw, 2, 2))
    mv[kind <= 2] = 0
    sd.mv[:] = np.repeat(np.repeat(mv, 2, 2), 2, 3)
    if sub8x8:
        sd.mv[kind == 7] = rng.integers(-mv_range, mv_range,
                                        (int((kind == 7).sum()), 4, 4, 2))

    lmask = rng.random((gh, gw, 16, 4, 4)) < 0.08
    lmask[rng.random((gh, gw, 16)) < 0.6] = False
    sd.luma_ac[:] = np.where(lmask, rng.integers(-40, 40, lmask.shape), 0)
    sd.luma_ac[kind == 1, :, 0, 0] = 0                 # I16: AC levels only
    dmask = (rng.random((gh, gw, 4, 4)) < 0.4) & (kind == 1)[..., None, None]
    sd.luma_dc[:] = np.where(dmask, rng.integers(-30, 30, dmask.shape), 0)
    cmask = rng.random((gh, gw, 2, 4, 4, 4)) < 0.06
    cmask[..., 0, 0] = False                           # chroma AC: 15 levels
    sd.chroma_ac[:] = np.where(cmask, rng.integers(-20, 20, cmask.shape), 0)
    cdmask = rng.random((gh, gw, 2, 2, 2)) < 0.2
    sd.chroma_dc[:] = np.where(cdmask, rng.integers(-12, 12, cdmask.shape),
                               0)
    _fill_total_coeff(sd)

    rows = np.array_split(np.arange(gh), len(slices))
    for sid, (band, (idc, a, b)) in enumerate(zip(rows, slices)):
        sd.slice_id[band] = sid
        sd.deblock_idc[band] = idc
        sd.alpha_off[band] = a
        sd.beta_off[band] = b
    sd.ref_idx[:] = 0
    return sd


def _fill_total_coeff(sd):
    """The parse's TotalCoeff maps from the levels: luma blocks in blkIdx
    order onto the 4x4 grid, chroma AC onto the chroma 4x4 grid."""
    gh, gw = sd.gh, sd.gw
    tc = (sd.luma_ac != 0).sum(axis=(3, 4))                # (gh,gw,16)
    raster = np.empty_like(tc)
    raster[:, :, P._BLK_RASTER_OF] = tc
    sd.nnz_luma[:] = raster.reshape(gh, gw, 4, 4).transpose(0, 2, 1, 3) \
        .reshape(4 * gh, 4 * gw)
    tcc = (sd.chroma_ac != 0).sum(axis=(4, 5))             # (gh,gw,2,4)
    sd.nnz_chroma[:] = tcc.reshape(gh, gw, 2, 2, 2) \
        .transpose(0, 3, 1, 4, 2).reshape(2 * gh, 2 * gw, 2)


# name -> (gw, gh, picture options, chroma_qp_index_offset, masks given);
# "random_flags" in the options: MB-edge and internal filter flags drawn
# at random, the picture's edges included, in place of _filter_flags'
CASES = {
    "idr_cif": (22, 18, dict(idr=True), 0, True),
    "p_cif": (22, 18, dict(intra=0.2), 2, True),
    "p_cif_no_masks": (22, 18, dict(intra=0.2), 0, False),
    "edge_clamp": (11, 9, dict(intra=0.1, clamp=True), 0, True),
    "slices_idc_0_1_2": (22, 18, dict(slices=((0, 4, -2), (1, -6, 6),
                                               (2, 12, -12))), 0, True),
    "chroma_offset_minus12": (22, 18, dict(intra=0.2), -12, True),
    "chroma_offset_plus12": (22, 18, dict(intra=0.2), 12, True),
    "idr_720p": (80, 45, dict(idr=True), 0, True),
    "p_720p": (80, 45, dict(intra=0.05), 0, False),
    "idr_1080p": (120, 68, dict(idr=True), 0, True),
    "p_1080p": (120, 68, dict(intra=0.05,
                              slices=((0, 2, 2), (2, -2, 0))), 1, True),
    "sub8x8_random_flags": (22, 18, dict(intra=0.2, sub8x8=True, mv_range=6,
                                         random_flags=True), 0, True),
}


def _pack_args(rng, sd, offset, masks, random_flags=False):
    shape = (sd.gh, sd.gw)
    if random_flags:
        fmb_v, fmb_h, fint = (rng.random(shape) < 0.8 for _ in range(3))
    else:
        fmb_v, fmb_h, fint = Decoder._filter_flags(sd)
    av = ({k: rng.random(shape) < 0.7 for k in ("al", "at", "atr")}
          if masks else {})
    return (fmb_v, fmb_h, fint, 3, offset), av


def _assert_same(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (got.wslot, got.ref_slot) == (want.wslot, want.ref_slot)


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_pack_matches_oracles(case):
    from hartallo_tpu.decode import d_pool as J
    gw, gh, opts, offset, masks = CASES[case]
    opts = dict(opts)
    random_flags = opts.pop("random_flags", False)
    rng = np.random.default_rng(2100 + sorted(CASES).index(case))
    sd = _picture(rng, gw, gh, **opts)
    args, av = _pack_args(rng, sd, offset, masks, random_flags)
    before = tracing.snapshot()["counters"].get("decode.pack_native", 0)
    got = P.pack_fast(sd, *args, **av)
    assert tracing.snapshot()["counters"]["decode.pack_native"] == \
        before + 1
    want = P.pack_fast_py(sd, *args, **av)
    _assert_same(got, want)
    assert got.tags.shape[0] > 0 or opts.get("idr")
    if opts.get("idr"):
        assert got.ilist.shape[0] == gw * gh
    if J.eligible(sd, None) is None:
        _assert_same(got, J.pack_fast(sd, *args, **av))
    elif case == "p_cif":
        pytest.fail(J.eligible(sd, None))     # CIF P: the JAX package too
    assert (P.eligible(sd, None) is None) == \
        (case not in ("edge_clamp", "sub8x8_random_flags"))


@pytest.mark.parametrize("where", ["inter", "intra"])
def test_native_pack_overflow(where):
    """A level of 3000 at qp 51 makes a residual far past MAX_RES: every
    path raises, the native pass counting nothing."""
    from hartallo_tpu.decode import d_pool as J
    rng = np.random.default_rng(2150)
    sd = _picture(rng, 22, 18, intra=0.2)
    kinds = sd.mb_kind.reshape(-1)
    m = int(np.nonzero(kinds >= 3 if where == "inter" else kinds == 0)[0][0])
    my, mx = divmod(m, sd.gw)
    sd.qp[my, mx] = 51
    sd.luma_ac[my, mx, 5] = 0
    sd.luma_ac[my, mx, 5, 1, 2] = 3000
    _fill_total_coeff(sd)
    args, av = _pack_args(rng, sd, 0, True)
    before = tracing.snapshot()["counters"].get("decode.pack_native", 0)
    for fn in (P.pack_fast, P.pack_fast_py, J.pack_fast):
        with pytest.raises(OverflowError):
            fn(sd, *args, **av)
    assert tracing.snapshot()["counters"].get("decode.pack_native", 0) == \
        before
    sd.luma_ac[my, mx, 5, 1, 2] = 30                  # in range: no raise
    _assert_same(P.pack_fast(sd, *args, **av), P.pack_fast_py(sd, *args,
                                                               **av))


def test_native_pack_intra_guard_reads_the_int16_pool():
    """The intra guard reads the pool as stored: a DC level of 26255 at
    qp 24 gives 65638 in every sample of the block, 102 as int16, and no
    path raises."""
    from hartallo_tpu.decode import d_pool as J
    rng = np.random.default_rng(2151)
    sd = _picture(rng, 22, 18, intra=0.2)
    m = int(np.nonzero(sd.mb_kind.reshape(-1) == 0)[0][0])
    my, mx = divmod(m, sd.gw)
    sd.qp[my, mx] = 24
    sd.luma_ac[my, mx] = 0
    sd.luma_ac[my, mx, 5, 0, 0] = 26255
    _fill_total_coeff(sd)
    args, av = _pack_args(rng, sd, 0, True)
    got = P.pack_fast(sd, *args, **av)
    _assert_same(got, P.pack_fast_py(sd, *args, **av))
    _assert_same(got, J.pack_fast(sd, *args, **av))
    row = list(got.ilist[:, 0]).index(m)
    assert (got.ivals[row, 5] == 102).all()


def test_native_pack_refuses_a_mis_sized_array():
    """An array that does not hold the picture's MB count is refused
    before the library reads it."""
    rng = np.random.default_rng(2152)
    sd = _picture(rng, 6, 4)
    (fmb_v, fmb_h, fint, wslot, offset), av = _pack_args(rng, sd, 0, True)
    with pytest.raises(ValueError):
        P.pack_fast(sd, fmb_v[:, :5], fmb_h, fint, wslot, offset, **av)


@pytest.mark.parametrize("name", ["qcif_6", "qcif_6_slices3"])
def test_decode_native_pack_frames_and_counter(name, monkeypatch):
    stream, meta = load_fixture(name)
    before = tracing.snapshot()["counters"].get("decode.pack_native", 0)
    dec = Decoder(device="cpu")
    out = dec.decode_annexb(stream, tolerant=False)
    packed = tracing.snapshot()["counters"].get("decode.pack_native", 0) - \
        before
    assert [plane_md5(r.frame) for r in out] == meta["frame_md5"]
    assert dec.stats["kernel_pictures"] == len(out) == packed

    monkeypatch.setattr(P, "pack_fast", P.pack_fast_py)
    dec = Decoder(device="cpu")
    out_py = dec.decode_annexb(stream, tolerant=False)
    assert [plane_md5(r.frame) for r in out_py] == meta["frame_md5"]
    assert tracing.snapshot()["counters"].get("decode.pack_native", 0) - \
        before == packed
