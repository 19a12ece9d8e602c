"""The intra encode kernel's wrapper, its plain twin against the JAX
package's ``intra_encode_frame``, its routing, and the CUDA kernel against
the twin on a GPU.

- On CPU tensors ``intra_encode_frame_fast`` is the twin; it equals the
  JAX package's ``intra_encode_frame`` on the cases
  ``tests/test_torch_encode_intra.py`` leaves out: a single MB column
  (the right-edge rule on every MB), nonzero ``chroma_qp_off`` with qp 0
  and 51, ``avail_tr`` / ``avail_tl`` left as None, and a flat source
  (every argmin a tie).  Sources are ``bench.make_clip`` frames, maps
  seeded numpy; 1x5, 4x3 and 2x5 MBs.
- ``e_device.i_frame_fused`` and ``_p_frame_body`` (intra-in-P) reach the
  wrapper, and mixed devices raise.
- The table the wrapper hands the kernel has the layout
  ``csrc/intra_encode.cu`` reads.
- On a GPU (``cuda``), the kernel equals the twin on the cases of
  ``chip_smoke.py``'s intra phase up to 720p (a tall narrow picture of
  68 MB rows, one MB row and one MB among them), and an encode of the QCIF
  fixtures launches it once per IDR picture and once per P picture that
  has an intra MB.

Tolerance: exact equality of every output array and plane.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from _torch_port import (cuda_device, intra_case,  # noqa: F401
                         intra_lambda, load_fixture, slice_availability)
from bench import make_clip


def _tensors(args, kw, device="cpu"):
    """intra_case's numpy inputs as tensors on ``device``."""
    def t(a):
        if isinstance(a, tuple):
            return tuple(map(t, a))
        return torch.tensor(a, device=device) \
            if isinstance(a, np.ndarray) else a
    return t(args), {k: t(v) for k, v in kw.items()}


# (label, gw, gh, options): the cases test_torch_encode_intra.py leaves out
JAX_CASES = [
    ("single MB column", 1, 5, {"rows": 5}),
    ("qp 0 and 51, chroma offset -4", 4, 3, {"qp": (0, 51), "cqo": -4,
                                             "lam_qp": 45}),
    ("qp 0, chroma offset +5", 4, 3, {"qp": (0,), "cqo": 5, "lam_qp": 12}),
    ("avail_tr and avail_tl None", 2, 5, {"none_trtl": True, "rows": 5}),
    ("flat source", 4, 3, {"flat": True}),
]


def _np(a):
    return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)


def _out_eq(got, want):
    """All eleven outputs of two ``intra_encode_frame`` results equal."""
    for name in want[3]:
        np.testing.assert_array_equal(_np(got[3][name]), _np(want[3][name]),
                                      err_msg=name)
    for g, w, name in zip(got[:3], want[:3], "YUV"):
        np.testing.assert_array_equal(_np(g), _np(w), err_msg=name)


@pytest.mark.parametrize("label,gw,gh,opts", JAX_CASES,
                         ids=[c[0] for c in JAX_CASES])
def test_cpu_wrapper_equals_jax(label, gw, gh, opts):
    import jax.numpy as jnp

    from hartallo_tpu.encode.intra_encode import intra_encode_frame as J
    from hartallo_tpu_torch.encode import intra_encode_fast as F
    args, _ = intra_case(gw, gh, 70 + gw + gh, **opts)
    want = J(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
               for a in args), gw=gw, gh=gh)
    before = F.LAUNCHES
    got = F.intra_encode_frame_fast(*_tensors(args, {})[0], gw=gw, gh=gh)
    assert F.LAUNCHES == before
    _out_eq(got, want)
    if opts.get("flat"):
        # every available Intra16x16 mode of a flat picture costs 0: the
        # first available one wins (V, else H, else DC)
        al, at = args[5], args[6]
        np.testing.assert_array_equal(got[3]["i16_mode"].numpy(),
                                      np.where(at, 0, np.where(al, 1, 2)))


def test_cpu_masked_wrapper_equals_twin():
    from hartallo_tpu_torch.encode import intra_encode_fast as F
    args, kw = _tensors(*intra_case(4, 3, 9, masked=True))
    _out_eq(F.intra_encode_frame_fast(*args, **kw, gw=4, gh=3),
            F.intra_encode_frame(*args, **kw, gw=4, gh=3))


def test_devices_must_agree():
    from hartallo_tpu_torch.encode import intra_encode_fast as F
    args, _ = _tensors(*intra_case(2, 2, 3))
    with pytest.raises(ValueError, match="CUDA device or all on the CPU"):
        F.intra_encode_frame_fast(args[0].to("meta"), *args[1:], gw=2, gh=2)


def test_table_layout_matches_the_kernel():
    """The offsets T_* that csrc/intra_encode.cu reads its table at are
    where ``_tables`` puts each part."""
    from hartallo_tpu_torch.core import tables as T
    from hartallo_tpu_torch.encode import intra_encode_fast as F
    text = (pathlib.Path(F.__file__).parent.parent / "csrc" /
            "intra_encode.cu").read_text()
    off = {k: int(v) for k, v in re.findall(r"\b(T_[A-Z]+) = (\d+)", text)}
    tab = F._tables("cpu").numpy()
    parts = [("T_MF", T.QUANT_MF), ("T_V", T.QUANT_V),
             ("T_QBITS", T.QUANT_QBITS), ("T_F", np.asarray(T.QUANT_F)[0]),
             ("T_QPC", T.QP_SCALE_CHROMA)]
    for name, part in parts:
        part = np.asarray(part).ravel()
        np.testing.assert_array_equal(
            tab[off[name]:off[name] + part.size], part, err_msg=name)
    assert tab.size == off["T_WORDS"]


def _count_wrapper(monkeypatch):
    from hartallo_tpu_torch.encode import e_device as E
    real, calls = E.intra_encode_frame_fast, []

    def counted(*args, gw, gh, **kw):
        calls.append(kw.get("mb_mask") is not None)
        return real(*args, gw=gw, gh=gh, **kw)
    monkeypatch.setattr(E, "intra_encode_frame_fast", counted)
    return calls


def test_i_frame_fused_reaches_the_wrapper(monkeypatch):
    from hartallo_tpu_torch.encode.e_device import i_frame_fused, pack_src
    calls = _count_wrapper(monkeypatch)
    gw, gh = 4, 3
    W, H = gw * 16, gh * 16
    src = pack_src(make_clip(W, H, 1)[0], W, H, gw, gh)
    al, at, atr, atl = slice_availability(gw, gh, gh)
    i_frame_fused(torch.tensor(src), torch.full((gh, gw), 30),
                  intra_lambda(30),
                  *map(torch.tensor, (al, at, atr, atl, al, at)), gw=gw,
                  gh=gh, chroma_qp_off=0, deblock=True)
    assert calls == [False]


@pytest.mark.parametrize("intra_in_p", [True, False])
def test_p_frame_body_reaches_the_wrapper(monkeypatch, intra_in_p):
    """A P picture with a flat MB pasted into it (its intra estimate beats
    the ME cost): the masked form is called once with intra-in-P on, and
    not at all with it off."""
    from hartallo_tpu_torch.encode import e_device as E
    gw, gh = 4, 3
    W, H = gw * 16, gh * 16
    srcs = [E.pack_src(f, W, H, gw, gh) for f in make_clip(W, H, 2)]
    srcs[1][16:32, 16:32] = 77
    al, at, atr, atl = slice_availability(gw, gh, gh)
    qp = torch.full((gh, gw), 30)
    ref = E.i_frame_fused(torch.tensor(srcs[0]), qp, intra_lambda(30),
                          *map(torch.tensor, (al, at, atr, atl, al, at)),
                          gw=gw, gh=gh, chroma_qp_off=0, deblock=True)[2:]
    calls = _count_wrapper(monkeypatch)
    E.p_frame_fused(torch.tensor(srcs[1]), *ref, qp, intra_lambda(30),
                    torch.tensor(al), torch.tensor(at), gw=gw, gh=gh, rng=8,
                    refine=True, chroma_qp_off=0, deblock=True,
                    intra_in_p=intra_in_p)
    assert calls == ([True] if intra_in_p else [])


# chip_smoke.py's intra phase cases up to 720p (1080p stays in the smoke)
GPU_CASES = ["QCIF", "CIF", "4CIF", "720p", "CIF masked", "720p masked",
             "CIF 3 slices", "CIF flat",
             "CIF qp 0..51, offset -4, lambda of qp 12",
             "CIF qp 0..51, offset +5, lambda of qp 45",
             "352x1088, 68 rows of 22 MBs", "1920x16, one MB row", "one MB"]


@pytest.mark.cuda
@pytest.mark.parametrize("label", GPU_CASES)
def test_cuda_kernel_equals_plain_twin(cuda_device, label):
    import chip_smoke as CS
    from hartallo_tpu_torch.encode import intra_encode_fast as F
    k, (_, W, H, opts) = next((k, c) for k, c in enumerate(CS.INTRA_CASES)
                              if c[0] == label)
    gw, gh, args, kw = CS.intra_inputs(W, H, CS.SEED + k, **opts)
    ta, tkw = _tensors(args, kw, cuda_device)
    before = F.LAUNCHES
    got = F.intra_encode_frame_fast(*ta, **tkw, gw=gw, gh=gh)
    assert F.LAUNCHES == before + 1
    want = F.intra_encode_frame(*ta, **tkw, gw=gw, gh=gh)
    torch.cuda.synchronize()
    _out_eq(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qcif_8", "qcif_6_slices3"])
def test_cuda_encode_launches_per_intra_picture(cuda_device, monkeypatch,
                                                 name):
    from hartallo_tpu_torch.api import Codec, CodecConfig
    from hartallo_tpu_torch.encode import e_device as E
    from hartallo_tpu_torch.encode import intra_encode_fast as F
    want, meta = load_fixture(name)
    real, intra_p = E._intra_in_p_mask, []

    def counted(*args, **kw):
        mask = real(*args, **kw)
        intra_p.append(bool(mask.any()))
        return mask
    monkeypatch.setattr(E, "_intra_in_p_mask", counted)
    W, H, NF = meta["width"], meta["height"], meta["frames"]
    extra = {k: meta[k] for k in ("slices",) if k in meta}
    codec = Codec(CodecConfig(width=W, height=H, qp=meta["qp"], gop_size=NF,
                              deblock=meta["deblock"],
                              me_range=meta["me_range"], **extra),
                  device=cuda_device)
    before = F.LAUNCHES
    clip = make_clip(W, H, NF)
    res = [codec.encode(f, W, H) for f in clip] if extra else \
        codec.encode_frames(clip, W, H)
    assert b"".join(r.headers + r.data for r in res) == want
    assert len(intra_p) == NF - 1
    assert F.LAUNCHES - before == 1 + sum(intra_p)
