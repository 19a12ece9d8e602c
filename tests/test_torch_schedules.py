"""The schedules of the two CUDA kernels, proved on the CPU with their plain
twins' arithmetic.

- Intra (``csrc/d_gop.cu`` ``k_intra``): the kernel runs the intra MBs by
  slope-2 step t = mx + 2 my, the MBs of a step at once.  ``_intra_plain``
  run in step order, with the MBs of each step in list order and reversed,
  gives the same planes as raster order: on the IDR picture of cif_16 and
  on a random P picture with Intra4x4 and Intra16x16 MBs among inter MBs.
- Deblock (``csrc/deblock_wavefront.cuh``): one row of MBs per warp, row
  my filtering MB mx once row my - 1 has finished MB min(mx + 1, gw - 1).
  Filtering one MB at a time in orders that rule allows (the tightest lag,
  and random interleavings of the rows) gives the planes of the twin
  ``deblock_filter``, with and without slice-edge flags; a lag of one MB
  does not, so the test sees a schedule that is too eager.

Tolerance: exact equality of the planes.
"""
import numpy as np
import pytest
import torch

from _torch_port import load_fixture, queued_jobs

PAD = 32


def _step_orders(mbs, gw):
    """Two orders the kernel may take: the steps in order, the MBs of a
    step in list order, and the same with every step's MBs reversed."""
    from hartallo_tpu_torch.decode.d_gop_fast import intra_step
    steps = {}
    for i, m in enumerate(mbs):
        steps.setdefault(intra_step(m, gw), []).append(i)
    return ([i for t in sorted(steps) for i in steps[t]],
            [i for t in sorted(steps) for i in reversed(steps[t])])


def _intra_planes(ilist, ivals, gw, gh, seed, order):
    from hartallo_tpu_torch.decode.d_gop_fast import _intra_plain
    rng = np.random.default_rng(seed)
    planes = [torch.tensor(rng.integers(0, 256, (h * k + 2 * PAD,
                                                 w * k + 2 * PAD)),
                           dtype=torch.int32)
              for k, h, w in ((16, gh, gw), (8, gh, gw), (8, gh, gw))]
    _intra_plain(torch.as_tensor(ilist), torch.as_tensor(ivals),
                 ilist.shape[0], *planes, gw, order=order)
    return planes


def _random_p_payload(gw, gh, seed):
    from test_torch_ops import _slice_data
    from hartallo_tpu_torch.decode import d_pool
    rng = np.random.default_rng(seed)
    sd = _slice_data(rng, gw, gh)
    f = np.ones((gh, gw), bool)
    avail = [rng.random((gh, gw)) < 0.8 for _ in range(3)]
    ff = d_pool.pack_fast(sd, f, f, f, 1, 0, al=avail[0], at=avail[1],
                          atr=avail[2])
    assert 0 < ff.ilist.shape[0] < gw * gh
    return ff, gw, gh


@pytest.mark.parametrize("source", ["cif_16_idr", "random_p"])
def test_intra_step_order_equals_raster(source):
    if source == "cif_16_idr":
        jobs, (gw, gh, _, _) = queued_jobs(load_fixture("cif_16")[0])
        ff = jobs[0].fast
        assert ff.ilist.shape[0] == gw * gh
    else:
        ff, gw, gh = _random_p_payload(11, 9, seed=5)
    mbs = [int(m) for m in ff.ilist[:, 0]]
    want = _intra_planes(ff.ilist, ff.ivals, gw, gh, 3, None)
    for order in _step_orders(mbs, gw):
        got = _intra_planes(ff.ilist, ff.ivals, gw, gh, 3, order)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def _deblock_inputs(gw, gh, seed, flags):
    """The deblock kernel test's parameters on blocky planes: a level per
    4x4 block (2x2 in chroma) a few steps apart, plus a little noise, so
    that most edges pass the alpha/beta tests and filtered samples
    overlap."""
    from test_torch_deblock_kernel import _inputs, slice_edge_flags
    from hartallo_tpu_torch.ops.deblock import edge_params
    _, rest = _inputs(gw, gh, seed)
    if flags:
        rest = slice_edge_flags(rest, gh, seed)
    rng = np.random.default_rng(seed)
    planes = []
    for h, w, b in ((16 * gh, 16 * gw, 4), (8 * gh, 8 * gw, 2),
                    (8 * gh, 8 * gw, 2)):
        levels = rng.integers(0, 5, ((h + 2 * PAD) // b, (w + 2 * PAD) // b))
        planes.append(torch.tensor(
            110 + 5 * np.kron(levels, np.ones((b, b), np.int64)) +
            rng.integers(0, 2, (h + 2 * PAD, w + 2 * PAD)),
            dtype=torch.int32))
    aux = edge_params(*(torch.tensor(a) for a in rest))
    return planes, aux


def _deblock_in_order(planes, aux, order):
    """Filter one MB at a time, every V edge then every H edge of it (the
    spec's per-MB order), with the twin's edge filter."""
    from hartallo_tpu_torch.ops.deblock import (_chroma_params, _edge,
                                                _luma_params)
    pY, pU, pV = (p.clone() for p in planes)
    for mx, my in order:
        a = aux[my, mx][None].to(torch.int32)
        ty, tx = torch.tensor([my]), torch.tensor([mx])
        for vertical in (True, False):
            for e in range(4):
                _edge(pY, a, PAD + 16 * ty, PAD + 16 * tx, e, 16, vertical,
                      _luma_params(vertical, e), True)
            for pc in (pU, pV):
                for e in range(2):
                    _edge(pc, a, PAD + 8 * ty, PAD + 8 * tx, e, 8, vertical,
                          _chroma_params(vertical, e), False)
    return pY, pU, pV


def _row_wavefront(gw, gh, lag, rng=None):
    """An order of (mx, my) that the row wavefront with the given lag
    allows: the tightest one without ``rng``, else a random interleaving
    of the rows."""
    done, order = [0] * gh, []
    while len(order) < gw * gh:
        ready = [my for my in range(gh) if done[my] < gw and
                 (my == 0 or done[my - 1] >= min(done[my] + lag, gw))]
        my = ready[-1] if rng is None else ready[rng.integers(len(ready))]
        order.append((done[my], my))
        done[my] += 1
    return order


@pytest.mark.parametrize("flags", [False, True])
def test_deblock_row_wavefront_equals_twin(flags):
    from hartallo_tpu_torch.ops.deblock import deblock_filter
    gw, gh = 7, 5
    planes, aux = _deblock_inputs(gw, gh, 9, flags)
    want = deblock_filter(tuple(p.clone() for p in planes), aux, gw=gw,
                          gh=gh)
    rng = np.random.default_rng(4)
    orders = [_row_wavefront(gw, gh, 2)] + \
        [_row_wavefront(gw, gh, 2, rng) for _ in range(2)]
    assert len({tuple(o) for o in orders}) == 3
    for order in orders:
        got = _deblock_in_order(planes, aux, order)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    # a lag of one MB lets (mx, my) filter its top edge before the left
    # edge of (mx + 1, my - 1) has changed the samples it reads
    eager = _deblock_in_order(planes, aux, _row_wavefront(gw, gh, 1))
    assert any(not torch.equal(g, w) for g, w in zip(eager, want))
