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


# tests/test_engine.py's runtime-qp stream: (width, height, pictures) and
# the codec's configuration
RUNTIME_QP_CLIP = (96, 64, 3)
RUNTIME_QP_CONFIG = {"qp": 40, "gop_size": 3, "deblock": True,
                     "me_range": 8}


def runtime_qp_stream(engine, CodecConfig, clip, **kw) -> bytes:
    """The stream of an AVC ``ManagedCodec`` of ``engine`` (the JAX
    package's or the port's; ``kw`` goes to ``codec_create``) encoding
    ``clip`` with ``set_option("qp", 24)`` after the first picture."""
    W, H, _ = RUNTIME_QP_CLIP
    c = engine.codec_create(engine.CODEC_TYPE_H264_AVC,
                            CodecConfig(width=W, height=H,
                                        **RUNTIME_QP_CONFIG), **kw)
    r = c.encode(clip[0], W, H)
    data = r.headers + r.data
    c.set_option("qp", 24)
    for frame in clip[1:]:
        r = c.encode(frame, W, H)
        data += r.headers + r.data
    return data


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


def scaling_list_rewrite(stream: bytes) -> bytes:
    """The stream's SPS moves to the High profile with non-flat 4x4
    scaling lists (the default intra lists, a ramp for the inter lists)
    and flat 8x8 lists, the rewrite of tests/test_scaling_lists.py; every
    picture then takes the general decode path.  tools/make_port_fixtures.py
    stores this rewrite of qcif_6 as the qcif_6_sl fixture."""
    from hartallo_tpu.decode.params import DEFAULT_4X4_INTRA

    from _rewrite import rewrite_stream
    ramp = np.clip(np.arange(16) + 9, 8, 40).astype(np.int32)

    def edit(sps):
        sps.profile_idc = 100
        sps.scaling_lists_4x4 = [DEFAULT_4X4_INTRA] * 3 + [ramp] * 3
        sps.scaling_lists_8x8 = [np.full(64, 16, np.int32)] * 2
    return rewrite_stream(stream, edit_sps=edit)


def svc_config(CodecConfig, meta: dict):
    """The encoder configuration of an SVC fixture's metadata, for either
    package's ``CodecConfig`` class."""
    keys = ("qp", "gop_size", "deblock", "me_range", "temporal_layers",
            "svc_inter_layer_p", "svc_residual_pred", "quality_layers",
            "quality_qp_delta")
    cfg = CodecConfig(**{k: meta[k] for k in keys if k in meta})
    if len(meta["layers"]) == 1:
        cfg.width, cfg.height = meta["layers"][0]
    else:
        for w, h in meta["layers"]:
            cfg.add_layer(w, h)
    return cfg


def _resize_nearest(p, oh, ow):
    h, w = p.shape
    return p[(np.arange(oh) * h // oh)[:, None],
             (np.arange(ow) * w // ow)[None, :]]


def layer_clips(meta: dict):
    """The I420 clip of each layer of an SVC fixture: ``bench.make_clip``
    at the top layer's size; each lower layer from the one above it by
    ``downsample_dyadic_np`` at half its size, the same frames at the
    same size, and a nearest-sample resize otherwise (a non-dyadic
    ratio)."""
    from bench import make_clip
    from hartallo_tpu_torch.svc.upsample import downsample_dyadic_np

    layers, nf = meta["layers"], meta["frames"]
    clips = [make_clip(*layers[-1], nf)]
    for (w, h), (uw, uh) in zip(layers[-2::-1], layers[:0:-1]):
        frames = []
        for f in clips[0]:
            y = f[:uw * uh].reshape(uh, uw)
            u = f[uw * uh:uw * uh * 5 // 4].reshape(uh // 2, uw // 2)
            v = f[uw * uh * 5 // 4:].reshape(uh // 2, uw // 2)
            if (w, h) == (uw, uh):
                planes = (y, u, v)
            elif (2 * w, 2 * h) == (uw, uh):
                planes = tuple(downsample_dyadic_np(p) for p in (y, u, v))
            else:
                planes = (_resize_nearest(y, h, w),
                          _resize_nearest(u, h // 2, w // 2),
                          _resize_nearest(v, h // 2, w // 2))
            frames.append(np.concatenate([p.ravel() for p in planes]))
        clips.insert(0, frames)
    return clips


def svc_encode(codec, meta: dict) -> bytes:
    """Encode an SVC fixture's clips through ``codec.encode``, each
    picture of every layer in turn, lowest layer first."""
    clips = layer_clips(meta)
    out = b""
    for t in range(meta["frames"]):
        for (w, h), clip in zip(meta["layers"], clips):
            r = codec.encode(clip[t], w, h)
            out += r.headers + r.data
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


@pytest.fixture
def twin_checked_deblock(monkeypatch):
    """Wrap the deblock kernel's entry points where the decoder's general
    route calls it (``e_device.deblock_grids``), where the encoder calls
    it on the gathered parameters (``e_device.deblock_recon_device``) and
    where the GOP scan and the sharded decode call it (``d_gop``): every
    call is held against its plain twin on the same inputs, tolerance 0.
    Yields the (gw, gh) of each call."""
    from hartallo_tpu_torch.decode import d_gop as G
    from hartallo_tpu_torch.encode import e_device as E
    from hartallo_tpu_torch.ops import deblock_fast as D
    real, real_aux = E.deblock_frame_fast, E.deblock_frame_aux_fast
    calls = []

    def checked(planes, *rest, gw, gh):
        got = real(planes, *rest, gw=gw, gh=gh)
        want = D.deblock_frame_fast_plain(planes, *rest, gw=gw, gh=gh)
        assert all(bool((g == w).all()) for g, w in zip(got, want))
        calls.append((gw, gh))
        return got

    def checked_aux(planes, aux, *, gw, gh):
        got = real_aux(planes, aux, gw=gw, gh=gh)
        want = D.deblock_frame_aux_plain(planes, aux, gw=gw, gh=gh)
        assert all(bool((g == w).all()) for g, w in zip(got, want))
        calls.append((gw, gh))
        return got
    monkeypatch.setattr(E, "deblock_frame_fast", checked)
    monkeypatch.setattr(E, "deblock_frame_aux_fast", checked_aux)
    monkeypatch.setattr(G, "deblock_frame_fast", checked)
    return calls


@pytest.fixture(scope="module")
def one_torch_thread():
    """Run a module's eager torch work on one CPU thread: the port's
    encoder is thousands of small ops, which several test workers with a
    thread pool each slow down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def intra_lambda(qp: int) -> np.float32:
    """The encoder's f32 mode-decision lambda of ``qp``."""
    return np.float32(np.sqrt(0.85 * 2.0 ** ((qp - 12) / 3.0)))


def slice_availability(gw: int, gh: int, rows_per_slice: int):
    """Availability maps (left, top, top-right, top-left) of a picture cut
    into row slices."""
    from hartallo_tpu_torch.decode.intra_recon import (availability_masks,
                                                       availability_tl,
                                                       availability_tr)
    sid = (np.arange(gh) // rows_per_slice)[:, None].repeat(gw, 1)
    none = np.zeros((gh, gw), bool)
    return (*availability_masks(sid, False, none),
            availability_tr(sid, False, none),
            availability_tl(sid, False, none))


def intra_case(gw: int, gh: int, seed: int, qp=None, cqo: int = 2,
               lam_qp: int = 30, rows: int = 2, flat: bool = False,
               none_trtl: bool = False, masked: bool = False,
               diagonal: bool = False):
    """numpy inputs of ``intra_encode_frame`` at gw x gh MBs: (the
    positional arguments, the keyword arguments).  The source is the
    first ``bench.make_clip`` frame edge-padded as the encoder pads it,
    a flat grey picture, or with ``diagonal`` seeded noise constant along
    each anti-diagonal (x + y), which the diagonal down-left and vertical
    left Intra4x4 modes predict from the top-right samples; qp per MB
    drawn from 20..39, or from the
    values ``qp``; the availability maps of slices of ``rows`` MB rows
    (the top-right and top-left ones None with ``none_trtl``); with
    ``masked``, half the MBs in the mask and seeded base planes."""
    from bench import make_clip
    from hartallo_tpu_torch.encode.e_device import pack_src
    rng = np.random.default_rng(seed)
    W, H = gw * 16, gh * 16
    src = pack_src(make_clip(W, H, 1)[0], W, H, gw, gh)
    uv = src[H:].reshape(H // 2, 2, W // 2).astype(np.int32)
    planes = (src[:H].astype(np.int32), uv[:, 0], uv[:, 1])
    if flat:
        planes = tuple(np.full_like(p, 128) for p in planes)
    if diagonal:
        planes = tuple(rng.integers(0, 256, sum(p.shape))[
            np.add.outer(*map(np.arange, p.shape))].astype(np.int32)
            for p in planes)
    planes = tuple(np.pad(p, 32, mode="edge") for p in planes)
    qpm = rng.integers(20, 40, (gh, gw)) if qp is None else \
        np.asarray(qp)[rng.integers(0, len(qp), (gh, gw))]
    al, at, atr, atl = slice_availability(gw, gh, rows)
    if none_trtl:
        atr = atl = None
    kw = {}
    if masked:
        kw = {"base_planes": tuple(rng.integers(0, 256, p.shape)
                                   .astype(np.int32) for p in planes),
              "mb_mask": rng.random((gh, gw)) < 0.5}
    return (*planes, qpm.astype(np.int32), cqo, al, at, intra_lambda(lam_qp),
            atr, atl), kw


def me_planes(gw: int, gh: int, seed: int, kind: str = "textured",
              extra_rows: int = 0):
    """(src, ref) int32 luma planes of the motion search at gw x gh MBs,
    padded by 32, the reference ``extra_rows`` taller (as a band's halo
    reference may be).  textured: a gradient with noise and a shifted,
    noisy source (the planes of tests/test_torch_encode_ops.py); flat:
    both 128; periodic: a pattern of period 4 in both directions, so
    every offset by a multiple of 4 matches alike and the SADs tie."""
    rng = np.random.default_rng(seed)
    Hp, Wp = gh * 16 + 64, gw * 16 + 64
    y, x = np.mgrid[:Hp + extra_rows, :Wp]
    if kind == "flat":
        ref = np.full(y.shape, 128)
        src = ref[:Hp]
    elif kind == "periodic":
        ref = (x % 4) * 40 + (y % 4) * 13
        src = ref[:Hp]
    else:
        ref = ((x * 3 + y * 5) % 256 + rng.integers(0, 40, x.shape)) % 256
        src = np.clip(np.roll(ref, (2, -3), (0, 1))[:Hp] +
                      rng.integers(-3, 4, (Hp, Wp)), 0, 255)
    return (np.ascontiguousarray(src, np.int32),
            np.ascontiguousarray(ref, np.int32))


def me_refine_maps(gw: int, gh: int, seed: int, nparts: int = 4,
                   mv_max: int = 60):
    """Seeded quarter-pel MVs in +-mv_max (gh, gw, 16, 2) and partition
    maps over 0..nparts-1 (gh, gw, 16), int32, for the refinement."""
    r = np.random.default_rng(seed)
    return (r.integers(-mv_max, mv_max + 1, (gh, gw, 16, 2)).astype(np.int32),
            r.integers(0, nparts, (gh, gw, 16)).astype(np.int32))


def fs_case(gw, gh, seed, mv_max=30, tie=False):
    """Seeded full-search outputs (numpy, ``full_search_int``'s order and
    types): integer costs, with ``tie`` costs that make every partition
    scheme cost the same at lambda 0 for a third of the MBs."""
    r = np.random.default_rng(seed)

    def cost(*shape):
        return r.integers(0, 4000, (gh, gw, *shape)).astype(np.float32)

    def mv(*shape):
        return r.integers(-mv_max, mv_max + 1, (gh, gw, *shape, 2)) \
            .astype(np.int32)
    fs = [cost(), mv(), cost(2), mv(2), cost(2), mv(2), cost(4), mv(4)]
    if tie:
        same = r.random((gh, gw)) < 0.34
        for k in (2, 4, 6):
            fs[k][same] = np.float32(0)
            fs[k][same, 0] = fs[0][same]
    return fs
