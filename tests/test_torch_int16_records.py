"""The GOP scan's per-MB records as int16, from the parser to the kernels.

- The residual's twin (``decode/mc_decode_fast.residual_planes_plain``)
  on int16 records equals the JAX package's ``ops/wide
  .residual_planes_wide`` (fed the same fields widened to int32) on each
  of ``chip_smoke.RESIDUAL_SETS``' records that the parser could leave
  (no luma block with levels, 15%, all, each MB its own: I16 MBs with
  their DC alone among them, qp 0 and 51, levels at the int16 range's
  ends) at chroma QP offsets -12, 0 and 12.
- The deblock parameters' twin (``ops/deblock_fast
  .deblock_params_dec_plain``) on int16 records, the general route's
  (``pack_deblock_record``) and the scan's dense buffer, equals the JAX
  decoder's boundary strengths (``ops/wide.compute_bs_grids``) and edge
  parameters (``ops/deblock_pallas._edge_params``: alpha, beta and each
  line's tc0) at chroma QP offsets -12, 0 and 12.
- The parser leaves a luma block's levels 0 wherever its TotalCoeff is
  0, on the rows of every scan fixture and the sharded fixture: what the
  residual twin's and kernel's skip of uncoded blocks rests on.
- The wrappers and twins of both kernels, ``d_gop.decode_gop`` and the
  sharded band step refuse int32 records.
- The rows the decoder packs into its staging buffer
  (``d_fused.pack_slice_rows`` into ``decode/staging.RowStaging``, in
  batches of 3, each with a buffer of its own; one picture a band step)
  and sends to each GOP scan batch and band step equal
  ``d_fused.pack_slice_arrays``' rows of the same pictures, int16, on
  every scan fixture and the sharded fixture; a staging's buffer grows
  where the batch outgrows it, the earlier rows kept, and the rows of an
  earlier batch stay as they were.
- ``pack_deblock_record`` holds the fields and a zero word, int16.
- On a GPU (``cuda``): the scan batch of ``qcif_6_wp`` reaches the card
  from page-locked memory as int16 through ``RowStaging.upload`` and
  decodes to its MD5s.

Tolerance: exact equality.
"""
import numpy as np
import pytest
import torch

import chip_smoke as CS
from _torch_port import cuda_device, load_fixture  # noqa: F401

# the records the parser could leave (stray levels are not among them)
PARSED_SETS = [c for c in CS.RESIDUAL_SETS if not c[2]]


def _jax_residual(rec, offs, cqo, gw, gh):
    import jax.numpy as jnp
    from hartallo_tpu.core.tables import QP_SCALE_CHROMA
    from hartallo_tpu.ops.wide import residual_planes_wide
    M = rec.shape[0] * rec.shape[1]
    la, ld, ca, cd, qp, kind, _ = offs
    r = jnp.asarray(rec.astype(np.int32))
    return residual_planes_wide(
        r[:, :, la:la + 256].reshape(M, 16, 16),
        r[:, :, ld:ld + 16].reshape(M, 16),
        r[:, :, ca:ca + 128].reshape(M, 2, 4, 16),
        r[:, :, cd:cd + 8].reshape(M, 2, 4), r[:, :, qp].reshape(M),
        (r[:, :, kind] == 1).reshape(M), cqo, jnp.asarray(QP_SCALE_CHROMA),
        gw, gh)


@pytest.mark.parametrize("cqo", [-12, 0, 12])
@pytest.mark.parametrize("label,coded,stray", PARSED_SETS,
                         ids=[c[0] for c in PARSED_SETS])
def test_residual_twin_on_int16_sets_equals_jax(label, coded, stray, cqo):
    from hartallo_tpu_torch.decode.mc_decode_fast import residual_planes_plain
    gw, gh, K = 6, 3, 2
    rec, offs = CS.residual_rec_inputs(gw, gh, K, 60 + cqo, coded=coded)
    assert rec.dtype == np.int16
    got = residual_planes_plain(torch.tensor(rec), offs, cqo, gw=gw, gh=gh)
    for g, w in zip(got, _jax_residual(rec, offs, cqo, gw, gh)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _jax_params(rec, offs, cqo, gw, gh):
    """The JAX decoder's bS grids and the edge parameters of its deblock
    kernel's pre-gather for one picture's record, as (bs_vg, bs_hg, and
    per (direction, luma / chroma) the (alpha, beta) pairs of the MB
    edge and the internal edges and each line's tc0)."""
    import jax.numpy as jnp
    from hartallo_tpu.core.tables import QP_SCALE_CHROMA
    from hartallo_tpu.ops.deblock_pallas import _edge_params
    from hartallo_tpu.ops.wide import compute_bs_grids
    from hartallo_tpu_torch.ops.deblock_fast import DEBLOCK_FIELDS
    f = {}
    for (name, shape), o in zip(DEBLOCK_FIELDS, offs):
        n = int(np.prod(shape, dtype=int)) if shape else 1
        f[name] = rec[0, :, o:o + n].astype(np.int32).reshape(
            (gh, gw) + shape)
    nnz = f["nnz"].transpose(0, 2, 1, 3).reshape(4 * gh, 4 * gw)
    mvg = f["mv"].transpose(0, 2, 1, 3, 4).reshape(4 * gh, 4 * gw, 2)
    refg = f["ref_idx"].reshape(gh, gw, 2, 1, 2, 1).repeat(2, 3) \
        .repeat(2, 5).reshape(gh, gw, 4, 4).transpose(0, 2, 1, 3) \
        .reshape(4 * gh, 4 * gw)
    kind = f["kind"]
    bs_vg, bs_hg = (np.asarray(b) for b in compute_bs_grids(
        jnp.asarray((kind <= 2) | (kind == 8)), jnp.asarray(nnz),
        jnp.asarray(mvg), jnp.asarray(refg), jnp.asarray(f["fmb_v"] != 0),
        jnp.asarray(f["fmb_h"] != 0), jnp.asarray(f["fint"] != 0)))
    # [edge][segment] per MB
    bs_v = bs_vg.reshape(gh, 4, gw, 4).transpose(0, 2, 3, 1)
    bs_h = bs_hg.reshape(gh, 4, gw, 4).transpose(0, 2, 1, 3)
    qp = f["qp"]
    qpc = np.asarray(QP_SCALE_CHROMA)[np.clip(qp + cqo, 0, 51)]

    def left(a):
        return np.concatenate([a[:, :1], a[:, :-1]], axis=1)

    def top(a):
        return np.concatenate([a[:1], a[:-1]], axis=0)
    seg = jnp.arange(4)
    sets = {}
    for key, q, qn, bs in (("luma v", qp, left(qp), bs_v),
                           ("luma h", qp, top(qp), bs_h),
                           ("chroma v", qpc, left(qpc), bs_v),
                           ("chroma h", qpc, top(qpc), bs_h)):
        ab, _, tc0 = _edge_params(jnp.asarray((qn + q + 1) >> 1),
                                  jnp.asarray(q),
                                  jnp.asarray(f["alpha_off"]),
                                  jnp.asarray(f["beta_off"]),
                                  jnp.asarray(bs), seg)
        sets[key] = (np.asarray(ab), np.asarray(tc0))
    return bs_v, bs_h, sets


@pytest.mark.parametrize("cqo", [-12, 0, 12])
@pytest.mark.parametrize("wide", [False, True],
                         ids=["general route's record",
                              "scan's dense buffer"])
def test_params_twin_on_int16_equals_jax_bs_and_edge_params(wide, cqo):
    from hartallo_tpu_torch.ops.deblock_fast import deblock_params_dec_plain
    gw, gh = 7, 5
    rec, offs = CS.deblock_rec_inputs(gw, gh, 1, 80 + cqo, wide=wide,
                                      edge_flags=True)
    assert rec.dtype == np.int16
    aux = deblock_params_dec_plain(torch.tensor(rec), offs, cqo, gw=gw,
                                   gh=gh)[0].numpy().astype(np.int32)
    bs_v, bs_h, sets = _jax_params(rec, offs, cqo, gw, gh)
    np.testing.assert_array_equal(aux[..., 30:46].reshape(gh, gw, 4, 4),
                                  bs_v)
    np.testing.assert_array_equal(aux[..., 46:62].reshape(gh, gw, 4, 4),
                                  bs_h)
    # the row's sets: 0 / 1 the luma MB edges (v, h), 2 the luma internal
    # edges, 3-5 chroma's; alpha, beta at 2 set, tc0 for bS 1-3 at 12 +
    # 3 set
    for key, edge_set, int_set in (("luma v", 0, 2), ("luma h", 1, 2),
                                   ("chroma v", 3, 5), ("chroma h", 4, 5)):
        ab, tc0 = sets[key]
        bs = bs_v if key.endswith("v") else bs_h
        for e, s in ((0, edge_set), (1, int_set)):
            np.testing.assert_array_equal(aux[..., 2 * s:2 * s + 2],
                                          ab[:, :, e], err_msg=key)
        for edge in range(4):
            s = edge_set if edge == 0 else int_set
            lines = bs[:, :, edge]
            tcs = np.concatenate([np.zeros((gh, gw, 1), np.int32),
                                  aux[..., 12 + 3 * s:15 + 3 * s]], -1)
            want = np.take_along_axis(tcs, np.clip(lines, 0, 3), -1)
            np.testing.assert_array_equal(tc0[:, :, edge], want,
                                          err_msg=f"{key} edge {edge}")


def _refusers():
    from hartallo_tpu_torch.decode import d_gop as G
    from hartallo_tpu_torch.decode import mc_decode_fast as M
    from hartallo_tpu_torch.ops import deblock_fast as D
    from hartallo_tpu_torch.parallel import shard as S
    gw, gh = 3, 2
    res, res_offs = CS.residual_rec_inputs(gw, gh, 1, 5)
    par, par_offs = CS.deblock_rec_inputs(gw, gh, 1, 5)
    rings = [torch.zeros(s, dtype=torch.uint8)
             for s in G.ring_shapes(gw, gh, 2)]
    mesh = S.Mesh(("cpu",) * 2)
    band_rings = [S._split(np.zeros((2, h, w), np.int32), mesh, dim=1)
                  for h, w in ((32, 48), (16, 24), (16, 24))]
    return {
        "residual_planes_fast": lambda: M.residual_planes_fast(
            torch.tensor(res, dtype=torch.int32), res_offs, 0, gw=gw,
            gh=gh),
        "residual_planes_plain": lambda: M.residual_planes_plain(
            torch.tensor(res, dtype=torch.int32), res_offs, 0, gw=gw,
            gh=gh),
        "deblock_params_dec_fast": lambda: D.deblock_params_dec_fast(
            torch.tensor(par, dtype=torch.int32), par_offs, 0, gw=gw,
            gh=gh),
        "deblock_params_dec_plain": lambda: D.deblock_params_dec_plain(
            torch.tensor(par, dtype=torch.int32), par_offs, 0, gw=gw,
            gh=gh),
        "decode_gop": lambda: G.decode_gop(
            res.astype(np.int32), [0], [False], *rings, gw=gw, gh=gh,
            chroma_qp_off=0),
        "decode_frame_step_sharded": lambda: S.decode_frame_step_sharded(
            mesh, res[0].astype(np.int32), *band_rings, 0, gw=gw, gh=gh,
            chroma_qp_off=0, has_intra=False, S=2),
    }


@pytest.mark.parametrize("name", ["residual_planes_fast",
                                  "residual_planes_plain",
                                  "deblock_params_dec_fast",
                                  "deblock_params_dec_plain", "decode_gop",
                                  "decode_frame_step_sharded"])
def test_int32_records_are_refused(name):
    with pytest.raises(ValueError, match="int16"):
        _refusers()[name]()


def _staged_and_packed(name, sharded=False):
    """Decode fixture ``name`` on the CPU with its scan batches (band
    steps) caught before any pixel work: returns the rows each batch
    reached the route with and ``pack_slice_arrays``' rows of the same
    pictures, on the arguments the decoder packed them from."""
    from hartallo_tpu_torch.decode import decoder as DM
    from hartallo_tpu_torch.decode.d_fused import pack_slice_arrays
    from hartallo_tpu_torch.parallel import shard as S
    stream, _ = load_fixture(name)
    got, want = [], []
    real_rows = DM.pack_slice_rows

    def rows(*args, out, **kw):
        want.append(pack_slice_arrays(*args, **kw))
        return real_rows(*args, out=out, **kw)
    DM.pack_slice_rows = rows
    if sharded:
        def step(mesh, packed, ringY, ringU, ringV, wslot, *, gw, gh, **kw):
            got.append(torch.as_tensor(packed).clone()[None])
            n = len(mesh.devices)
            H, W = gh * 16, gw * 16
            y = tuple(torch.zeros((H // n, W), dtype=torch.uint8)
                      for _ in mesh.devices)
            uv = tuple(torch.zeros((H // n // 2, W), dtype=torch.uint8)
                       for _ in mesh.devices)
            return y, uv, ringY, ringU, ringV
        real, S.decode_frame_step_sharded = S.decode_frame_step_sharded, step
        try:
            S.ShardedDecoder(S.Mesh(("cpu",) * 2)).decode_annexb(
                stream, tolerant=False)
        finally:
            S.decode_frame_step_sharded = real
            DM.pack_slice_rows = real_rows
    else:
        def scan(packed, write_slot, has_intra, ringY, ringU, ringV, *,
                 gw, gh, chroma_qp_off):
            got.append(packed.clone())
            out = torch.zeros((len(write_slot), gh * 24, gw * 16),
                              dtype=torch.uint8)
            return out, ringY, ringU, ringV

        def kernel(smb, *args, gw, gh):        # the IDR picture: skipped
            out = torch.zeros((smb.shape[0], gh * 24, gw * 16),
                              dtype=torch.uint8)
            return (out, *args[6:9])
        real = DM.decode_gop, DM.decode_gop_fast
        DM.decode_gop, DM.decode_gop_fast = scan, kernel
        try:
            DM.Decoder(device="cpu", batch_k=3).decode_annexb(
                stream, tolerant=False)
        finally:
            DM.decode_gop, DM.decode_gop_fast = real
            DM.pack_slice_rows = real_rows
    return got, want


@pytest.mark.parametrize("name", [*CS.SCAN, "shard_96x64_8"])
def test_staged_rows_equal_pack_slice_arrays(name):
    sharded = name.startswith("shard")
    got, want = _staged_and_packed(name, sharded)
    assert got and sum(len(g) for g in got) == len(want)
    assert all(g.dtype == torch.int16 for g in got)
    np.testing.assert_array_equal(torch.cat(got).numpy(), np.stack(want))
    if not sharded:
        assert len(got) > 1 or len(want) <= 3


@pytest.mark.parametrize("name", [*CS.SCAN, "shard_96x64_8"])
def test_parsed_uncoded_luma_blocks_have_no_levels(name):
    # residual_planes_plain (and the kernel) read a luma block's levels
    # only where its TotalCoeff is above 0; the parser leaves the others 0
    from hartallo_tpu_torch.decode.d_gop import _OFF
    from hartallo_tpu_torch.decode.mc_decode_fast import _BLK_RASTER
    rows = np.stack(_staged_and_packed(name, name.startswith("shard"))[1])
    o0, o1, _ = _OFF["luma_ac"]
    levels = rows[:, :, o0:o1].reshape(rows.shape[:2] + (16, 16))
    n0, n1, _ = _OFF["nnz"]
    nnz = rows[:, :, n0:n1][:, :, _BLK_RASTER.numpy()]    # blkIdx order
    coded = (levels != 0).any(-1)
    assert coded.any() and (nnz == 0).any()
    assert not (coded & (nnz == 0)).any()


def test_staging_grows_and_keeps_each_batch():
    from hartallo_tpu_torch.decode.staging import RowStaging
    rng = np.random.default_rng(4)
    batches = []
    for n in (5, 1, 3):                      # the first outgrows capacity 2
        st = RowStaging("cpu", capacity=2)
        rows = rng.integers(-500, 500, (n, 6, 8)).astype(np.int16)
        for i, r in enumerate(rows):
            st.row(i, (6, 8))[...] = r
        got = st.upload(st.rows(0, n))
        assert got.dtype == torch.int16 and got.shape == (n, 6, 8)
        batches.append((rows, got))
    for rows, got in batches:
        np.testing.assert_array_equal(got.numpy(), rows)
    assert st.capacity == 2 and st.rows(0, 3).shape == (3, 6, 8)
    with pytest.raises(ValueError):
        st.row(1, (7, 8))


def test_pack_deblock_record_is_int16_with_a_zero_word():
    from hartallo_tpu_torch.ops.deblock_fast import (DEBLOCK_FIELDS,
                                                     RECORD_OFFSETS,
                                                     RECORD_WORDS,
                                                     pack_deblock_record)
    gw, gh = 4, 3
    rng = np.random.default_rng(3)
    values = {name: rng.integers(-300, 300, (gh, gw) + shape)
              for name, shape in DEBLOCK_FIELDS}
    rec = pack_deblock_record(values, gw, gh)
    assert rec.dtype == np.int16 and rec.shape == (gh * gw, RECORD_WORDS)
    assert RECORD_WORDS % 4 == 0 and RECORD_WORDS == 60
    for (name, shape), o in zip(DEBLOCK_FIELDS, RECORD_OFFSETS):
        n = int(np.prod(shape, dtype=int)) if shape else 1
        np.testing.assert_array_equal(rec[:, o:o + n],
                                      values[name].reshape(gh * gw, n))
    assert not rec[:, 59:].any()


@pytest.mark.cuda
def test_cuda_scan_batch_is_uploaded_pinned_as_int16(cuda_device):
    from hartallo_tpu_torch.api import Codec, CodecConfig
    from hartallo_tpu_torch.decode import decoder as DM
    from hartallo_tpu_torch.decode.staging import RowStaging
    stream, meta = load_fixture("qcif_6_wp")
    seen = []
    real_upload, real_scan = RowStaging.upload, DM.decode_gop

    def upload(self, host):
        out = real_upload(self, host)
        seen.append((host.is_pinned(), host.dtype, out.dtype,
                     out.device.type, torch.equal(out.cpu(), host)))
        return out

    def scan(packed, *args, **kw):
        seen.append(("scan", packed.dtype, packed.device.type))
        return real_scan(packed, *args, **kw)
    RowStaging.upload, DM.decode_gop = upload, scan
    try:
        out = Codec(CodecConfig(), device=cuda_device).decode_annexb(
            stream, tolerant=False)
    finally:
        RowStaging.upload, DM.decode_gop = real_upload, real_scan
    assert [CS.frame_md5(r.frame) for r in out] == meta["frame_md5"]
    assert seen == [(True, torch.int16, torch.int16, "cuda", True),
                    ("scan", torch.int16, "cuda")]
