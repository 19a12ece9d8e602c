"""Shared helpers of the PyTorch port's tests (tests/test_torch_*.py)."""
from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest
import torch

DATA = pathlib.Path(__file__).resolve().parent / "data" / "port"


def encode_clip(W=64, H=48, NF=5) -> bytes:
    """A small stream encoded by the JAX package (I picture, then P
    pictures with skips, MVs, residual and intra-in-P)."""
    from test_decode_pallas import _encode_clip
    return _encode_clip(W, H, NF)


def load_fixture(name):
    """(stream bytes, metadata) of tests/data/port/<name>."""
    return ((DATA / f"{name}.264").read_bytes(),
            json.loads((DATA / f"{name}.json").read_text()))


def weighted_rewrite(stream: bytes) -> bytes:
    """Every P slice of ``stream`` moves to a second PPS that sets
    weighted_pred_flag, with an explicit weight table of its own (the
    slice data bits are copied verbatim).  tools/make_port_fixtures.py
    stores this rewrite of qcif_6 as the qcif_6_wp fixture."""
    from hartallo_tpu.bitio import BitReader, BitWriter, find_nal_units, \
        strip_emulation_prevention
    from hartallo_tpu.decode import nal as N
    from hartallo_tpu.decode.params import PPS, SPS
    from hartallo_tpu.decode.sliceheader import (PredWeightTable,
                                                 parse_slice_header,
                                                 write_slice_header)

    from _rewrite import annexb, copy_payload_bits
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


def queued_jobs(stream: bytes, device="cpu", eligible=None):
    """Parse a stream with the port's decoder without decoding it; returns
    (jobs, (gw, gh, S, chroma_qp_off)).  ``eligible`` replaces
    ``d_pool.eligible`` (e.g. to send every picture to the GOP scan)."""
    from hartallo_tpu_torch.decode import d_pool
    from hartallo_tpu_torch.decode.decoder import Decoder
    dec = Decoder(device=device, batch_k=1 << 30)
    orig = d_pool.eligible
    if eligible is not None:
        d_pool.eligible = eligible
    try:
        dec.enqueue_annexb(stream, tolerant=False)
    finally:
        d_pool.eligible = orig
    return dec.layer.jobs, dec.layer.ring_key


def seeded_rings(gw, gh, S, seed):
    from hartallo_tpu_torch.decode.d_gop import ring_shapes
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, 256, s, dtype=np.uint8)
                 for s in ring_shapes(gw, gh, S))


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips where torch sees none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "False")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def one_torch_thread():
    """Run a module's eager torch work on one CPU thread: the port's
    encoder is thousands of small ops, which several test workers with a
    thread pool each slow down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
