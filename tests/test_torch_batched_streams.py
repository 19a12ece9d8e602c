"""The PyTorch port on the batched path's harder stream classes:
explicit weighted prediction, and DPB rewrites (MMCO operations 1-6,
long-term references, reference-list modifications) with two reference
frames, which gives a ring of three slots.

Streams: the qcif_6 fixture (176x144, 6 pictures, encoded by
``hartallo_tpu``), whose parameter sets and slice headers are rewritten
by ``tests/_rewrite.py`` (the slice data bits are copied verbatim), as
``test_dpb_stress.py`` and ``test_weighted_pred.py`` build theirs.  On the
CPU the port and the JAX package decode each stream; on a GPU (no JAX
there) the port on the card and the port on the CPU.  Tolerance: exact
equality of every frame, since this is an integer codec.
"""
from functools import partial

import numpy as np
import pytest

from hartallo_tpu.decode.sliceheader import MMCO, RefPicListMod

from _rewrite import rewrite_stream
from _torch_port import (cuda_device, load_fixture,  # noqa: F401
                         weighted_rewrite)

NF = 6


@pytest.fixture(scope="module")
def base_stream():
    stream, meta = load_fixture("qcif_6")
    assert meta["frames"] == NF
    return stream


def _two_refs(sps):
    sps.max_num_ref_frames = 2


def _mmco1(sh, hdr, i):
    """Each P slice unmarks the older short-term reference."""
    sh.adaptive_ref_pic_marking_mode_flag = 1
    if i > 0:
        sh.mmcos.append(MMCO(op=1, value1=1))


def _mmco3(sh, hdr, i):
    """The older short-term reference is promoted to long-term, then
    unmarked."""
    sh.adaptive_ref_pic_marking_mode_flag = 1
    if i > 0:
        sh.mmcos += [MMCO(op=4, value1=1), MMCO(op=3, value1=1, value2=0),
                     MMCO(op=2, value1=0)]


def _longterm_passenger(sh, hdr, i):
    """The IDR picture rides in the DPB as long-term while the short-term
    window cycles; the last P slice unmarks it."""
    if i == 0:
        sh.adaptive_ref_pic_marking_mode_flag = 1
        sh.mmcos += [MMCO(op=4, value1=1), MMCO(op=3, value1=0, value2=0)]
    elif i == NF - 2:
        sh.adaptive_ref_pic_marking_mode_flag = 1
        sh.mmcos += [MMCO(op=2, value1=0), MMCO(op=1, value1=1)]


def _mmco6_chain(sh, hdr, i):
    """Every P slice predicts from the long-term previous picture (a
    long-term ref-list modification), then takes its place (MMCO 2, 6)."""
    sh.adaptive_ref_pic_marking_mode_flag = 1
    if i == 0:
        sh.mmcos += [MMCO(op=4, value1=1), MMCO(op=6, value1=0)]
        return
    sh.ref_pic_list_mods_l0 = [RefPicListMod(idc=2, value=0)]
    if i == 1:
        sh.mmcos.append(MMCO(op=1, value1=1))
    sh.mmcos += [MMCO(op=2, value1=0), MMCO(op=6, value1=0)]


def _reflist_identity(sh, hdr, i):
    sh.ref_pic_list_mods_l0 = [RefPicListMod(idc=0, value=0)]


def _mmco5_last(sh, hdr, i):
    """A reset (MMCO 5) on the last P slice."""
    if i == NF - 2:
        sh.adaptive_ref_pic_marking_mode_flag = 1
        sh.mmcos.append(MMCO(op=5))


def _dpb(edit_slice, edit_sps=_two_refs):
    return partial(rewrite_stream, edit_sps=edit_sps, edit_slice=edit_slice)


# name -> the rewrite of the base stream
VARIANTS = {
    "mmco1_two_refs": _dpb(_mmco1),
    "mmco3_promote": _dpb(_mmco3),
    "longterm_passenger": _dpb(_longterm_passenger),
    "mmco6_longterm_chain": _dpb(_mmco6_chain),
    "reflist_mod_identity": _dpb(_reflist_identity),
    "mmco5_reset": _dpb(_mmco5_last, edit_sps=None),
    "weighted_pred": weighted_rewrite,
}


def _port_decode(stream, device):
    from hartallo_tpu_torch.api import Codec, CodecConfig
    codec = Codec(CodecConfig(), device=device)
    return codec.decode_annexb(stream, tolerant=False), codec.decoder.stats


def _assert_same_frames(got, want):
    assert len(got) == len(want) == NF
    for i, (a, b) in enumerate(zip(got, want)):
        assert (a.width, a.height, a.poc) == (b.width, b.height, b.poc)
        np.testing.assert_array_equal(a.frame, b.frame, err_msg=f"frame {i}")


@pytest.mark.parametrize("name", list(VARIANTS))
def test_port_decodes_like_jax(base_stream, name):
    from hartallo_tpu.api import Codec, CodecConfig
    stream = VARIANTS[name](base_stream)
    want = Codec(CodecConfig()).decode_annexb(stream, tolerant=False)
    got, stats = _port_decode(stream, "cpu")
    _assert_same_frames(got, want)
    # the kernel refuses weighted prediction: those P pictures take the
    # GOP scan; every DPB variant takes the kernel, three ring slots or two
    scan = NF - 1 if name == "weighted_pred" else 0
    assert stats == {"kernel_pictures": NF - scan, "scan_pictures": scan,
                     "general_pictures": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(VARIANTS))
def test_cuda_decodes_like_cpu(cuda_device, base_stream, name):
    stream = VARIANTS[name](base_stream)
    got, stats = _port_decode(stream, cuda_device)
    want, want_stats = _port_decode(stream, "cpu")
    _assert_same_frames(got, want)
    assert stats == want_stats
