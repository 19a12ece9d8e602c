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

from hartallo_tpu.bitio import BitReader, BitWriter, find_nal_units, \
    strip_emulation_prevention
from hartallo_tpu.decode import nal as N
from hartallo_tpu.decode.params import PPS, SPS
from hartallo_tpu.decode.sliceheader import (MMCO, PredWeightTable,
                                             RefPicListMod,
                                             parse_slice_header,
                                             write_slice_header)

from _rewrite import annexb, copy_payload_bits, rewrite_stream
from _torch_port import cuda_device, load_fixture  # noqa: F401

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


def _weighted(stream):
    """Every P slice moves to a second PPS that sets weighted_pred_flag,
    with an explicit weight table of its own."""
    out = b""
    sps = pps = wpps = None
    i = 0
    for s0, e0 in find_nal_units(stream):
        nal = stream[s0:e0]
        data = strip_emulation_prevention(nal)
        r = BitReader(data)
        hdr = N.parse_nal_header(r)
        out_nal = b"\x00\x00\x00\x01" + nal
        if hdr.type == N.NAL_SPS:
            sps = SPS.parse(r)
        elif hdr.type == N.NAL_PPS:
            pps = PPS.parse(r)
            wpps = PPS.parse(BitReader(data[1:]))
            wpps.pic_parameter_set_id = 1
            wpps.weighted_pred_flag = 1
            w = BitWriter()
            N.write_nal_header(w, 3, N.NAL_PPS)
            wpps.write(w)
            out_nal += annexb(w.getvalue())
        elif hdr.type == N.NAL_SLICE:
            sh = parse_slice_header(r, sps, pps, nal_ref_idc=hdr.ref_idc,
                                    is_idr=False)
            sh.pic_parameter_set_id = 1
            sh.pred_weights = PredWeightTable(
                luma_log2_denom=5, chroma_log2_denom=2, luma_w=[20 + 3 * i],
                luma_o=[13 - 5 * i], chroma_w=[(3 + i, 7 - i)],
                chroma_o=[(-9 + 2 * i, 4)])
            i += 1
            w = BitWriter()
            N.write_nal_header(w, hdr.ref_idc, N.NAL_SLICE)
            write_slice_header(w, sh, sps, wpps, nal_ref_idc=hdr.ref_idc,
                               is_idr=False)
            copy_payload_bits(w, data, r.pos)
            out_nal = annexb(w.getvalue())
        out += out_nal
    return out


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
    "weighted_pred": _weighted,
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
    assert stats == {"kernel_pictures": NF - scan, "scan_pictures": scan}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(VARIANTS))
def test_cuda_decodes_like_cpu(cuda_device, base_stream, name):
    stream = VARIANTS[name](base_stream)
    got, stats = _port_decode(stream, cuda_device)
    want, want_stats = _port_decode(stream, "cpu")
    _assert_same_frames(got, want)
    assert stats == want_stats
