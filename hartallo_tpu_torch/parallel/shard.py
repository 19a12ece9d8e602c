"""Row-sharded encode and decode of the codec pixel pipeline over a mesh of
torch devices.

Port of ``hartallo_tpu/parallel/shard.py``.  A frame's MB rows are cut
into equal bands, band i on ``mesh.devices[i]``; each band is coded as
an independent slice (disable_deblocking_filter_idc 2 semantics at the
band edge) while motion compensation reads up to ``PAD`` rows into the
neighbour bands through a halo of reference rows.  The JAX package runs
the bands as one ``shard_map`` program and exchanges the halo with
``jax.lax.ppermute``; here one process drives the bands in turn, and the
exchange is a copy of the neighbour band's boundary rows onto this
band's device.  A mesh may name one device several times
(``Mesh(("cuda:0",) * 4)`` runs four real bands with real halos on one
card) and names the CPU only where the caller says so
(``Mesh(("cpu",) * 4)`` in the tests).  Each band's deblock is
``ops/deblock_fast.deblock_frame_aux_fast`` on gathered parameters, and
a decoded band's references, intra wavefront and deblock parameters are
the kernels of ``decode/d_gop``'s body: CUDA kernels on a CUDA device,
their plain twins on the CPU (the JAX package runs XLA here).

The sharded outputs stay per band on their devices: a tuple of band
tensors, concatenated by ``gather`` when a caller wants the whole array.
GOPs of a stream go to device groups in turn (``decode_gops_grouped``),
one after another.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from hartallo_tpu_torch.decode.d_gop import (_OFF, prepare_pictures,
                                             reconstruct_picture)
from hartallo_tpu_torch.decode.decoder import Decoder, _BatchOut
from hartallo_tpu_torch.decode.intra_recon import PAD
from hartallo_tpu_torch.encode.e_device import deblock_recon_device
from hartallo_tpu_torch.encode.p_body_fast import halfpel_planes_fast
from hartallo_tpu_torch.encode.p_device import p_frame_device
from hartallo_tpu_torch.ops.wide import _edge_pad, pad_edge


@dataclass(frozen=True)
class Mesh:
    """An ordered tuple of torch devices; band i of every sharded array
    lives on ``devices[i]``.  The bands are always MB-row bands (the JAX
    package's mesh axis, ``"rows"``)."""
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))


def make_mesh(n_devices: Optional[int] = None, *,
              device_type: str = "cuda") -> Mesh:
    """The first ``n_devices`` devices of ``device_type`` (all of them
    when None).  Raises when fewer exist; a mesh that repeats a device is
    built explicitly, e.g. ``Mesh(("cuda:0",) * 4)``."""
    count = getattr(torch, device_type).device_count()
    n = count if n_devices is None else n_devices
    if n < 1 or n > count:
        raise RuntimeError(f"make_mesh: {n} {device_type} devices asked "
                           f"for, {count} present")
    return Mesh(tuple(torch.device(device_type, i) for i in range(n)))


def gather(bands: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    """The whole array of a sharded output: its bands concatenated on
    ``device`` (band 0's by default)."""
    dev = bands[0].device if device is None else torch.device(device)
    return torch.cat([b.to(dev) for b in bands])


def _split(a, mesh: Mesh, dim: int = 0):
    """Cut ``a`` (numpy or tensor) into len(mesh.devices) equal int32
    bands along ``dim``, band i on devices[i]."""
    n = len(mesh.devices)
    if a.shape[dim] % n:
        raise ValueError(f"{a.shape[dim]} rows do not split into {n} bands")
    h = a.shape[dim] // n
    t = torch.as_tensor(a)
    return tuple(t.narrow(dim, i * h, h).to(dev, torch.int32)
                 for i, dev in enumerate(mesh.devices))


def _halo_pad(bands: Sequence[torch.Tensor], i: int) -> torch.Tensor:
    """Band i's (h, w) plane -> (h + 2 PAD, w + 2 PAD) on its device: the
    vertical pads are the neighbour bands' boundary rows (the halo), the
    global top and bottom bands and the horizontal pads edge-replicate,
    matching the single-device edge-padded layout."""
    x = bands[i]
    n, (h, w), dev = len(bands), x.shape, x.device
    k = min(PAD, h)                               # rows one neighbour holds
    if i == 0:
        top = x[:1].expand(PAD, w)
    else:
        top = bands[i - 1][-k:].to(dev)
        # a band shorter than the pad: extend with the farthest fetched row
        # (reads past one neighbour's band are outside the legal MV range)
        top = torch.cat([top[:1].expand(PAD - k, w), top])
    if i == n - 1:
        bot = x[-1:].expand(PAD, w)
    else:
        bot = bands[i + 1][:k].to(dev)
        bot = torch.cat([bot, bot[-1:].expand(PAD - k, w)])
    return _edge_pad(torch.cat([top, x, bot]), PAD, PAD, 1)


def _shard_deblock(wq, mv44, qp_l, qpc_off: int, planes, gw: int,
                   gh_l: int):
    """In-loop deblock of a P band (inter MBs, reference 0, no filtering
    across the band's top edge or the picture's left edge), through
    ``e_device.deblock_recon_device`` as the encoder's."""
    dev = wq.device
    return deblock_recon_device(
        wq, mv44, torch.zeros((gh_l, gw, 4, 4), dtype=torch.int32,
                              device=dev),
        torch.zeros((gh_l, gw), dtype=torch.bool, device=dev), qp_l,
        qpc_off, planes, gw, gh_l)


def p_encode_step_sharded(mesh: Mesh, srcY, srcU, srcV, refY, refU, refV,
                          qp, lam: float, *, gw: int, gh: int, rng: int,
                          chroma_qp_off: int = 0):
    """Row-sharded P-frame encode step: per band, integer full-search ME,
    partition decision, sub-pel refine, quarter-pel MC, residual
    transform and quant, recon (``p_frame_device``) and the band's
    in-loop deblock (always on: the JAX function's ``deblock=False``
    has no counterpart).

    srcY/refY (gh*16, gw*16) luma, srcU..refV half-size chroma, qp
    (gh, gw); numpy or tensors.  gh must divide evenly by the mesh size.
    Returns (wq, dcq, acq, mv44, choice, recY, recU, recV), each a tuple
    of per-band tensors on the band's device (MB-row axis first; the rec
    planes unpadded)."""
    n = len(mesh.devices)
    assert gh % n == 0, (gh, n)
    gh_l = gh // n
    assert rng <= PAD - 8
    sY, sU, sV, rY, rU, rV, qps = (_split(a, mesh) for a in (
        srcY, srcU, srcV, refY, refU, refV, qp))
    H, W = gh_l * 16, gw * 16
    outs = []
    for i in range(n):
        wq, dcq, acq, mv44, choice, recY, recU, recV, _ = p_frame_device(
            pad_edge(sY[i]), pad_edge(sU[i]), pad_edge(sV[i]),
            _halo_pad(rY, i), _halo_pad(rU, i), _halo_pad(rV, i), qps[i],
            lam, gw=gw, gh=gh_l, rng=rng, refine=True,
            chroma_qp_off=chroma_qp_off)
        recY, recU, recV = _shard_deblock(
            wq, mv44, qps[i], chroma_qp_off, (recY, recU, recV), gw, gh_l)
        outs.append((wq, dcq, acq, mv44, choice,
                     recY[PAD:PAD + H, PAD:PAD + W],
                     recU[PAD:PAD + H // 2, PAD:PAD + W // 2],
                     recV[PAD:PAD + H // 2, PAD:PAD + W // 2]))
    return tuple(zip(*outs))


# ---------------------------------------------------------------------------
# Sharded decode
# ---------------------------------------------------------------------------

def decode_frame_step_sharded(mesh: Mesh, packed, ringY, ringU, ringV,
                              wslot: int, *, gw: int, gh: int,
                              chroma_qp_off: int, has_intra: bool, S: int):
    """One picture of the decode pipeline row-sharded over the mesh.

    packed (gh*gw, WORDS) the picture's dense buffer
    (``d_fused.pack_slice_arrays``, MB raster order); ringY/U/V the
    UNPADDED reference rings (S, H, W) / (S, H/2, W/2) int32, each a
    tuple of per-band (S, H/n, ...) tensors on the bands' devices (cut a
    whole ring with ``_split(ring, mesh, dim=1)``).  The packed
    reference indices address ring slots; the recon lands in slot
    ``wslot``.  Streams must be
    band-independent (one slice per band or several, with
    disable_deblocking_filter_idc 2: the packed flags carry the slice
    edges, so the per-band deblock is exact).  Each band predicts from
    the half-pel planes of its halo'd ring slots and reconstructs with
    ``d_gop``'s per-picture body.

    Returns (y_u8, uv_u8, ringY', ringU', ringV'), each a tuple of band
    tensors: y (H_l, W) and uv (H_l/2, W) with U and V side by side per
    row, so that ``gather`` gives the whole planes; the rings are updated
    in place, after every band has read its halo."""
    n = len(mesh.devices)
    assert gh % n == 0, (gh, n)
    gh_l = gh // n
    rings = (ringY, ringU, ringV)
    packed = np.asarray(packed)
    pk = _split(packed, mesh)
    # a band without an Intra4x4 or Intra16x16 MB skips the intra
    # wavefront, which would leave its planes as they are
    kind = packed[:, _OFF["kind"][0]].reshape(n, gh_l * gw)
    band_intra = [has_intra and bool(np.isin(k, (0, 1)).any())
                  for k in kind]
    H, W = gh_l * 16, gw * 16
    recs = []
    for i in range(n):
        stackY = torch.stack([halfpel_planes_fast(_halo_pad(
            [r[si] for r in rings[0]], i)) for si in range(S)])
        stackU, stackV = (torch.stack([_halo_pad([r[si] for r in ring], i)
                                       for si in range(S)])
                          for ring in rings[1:])
        batch = prepare_pictures(pk[i][None], gw=gw, gh=gh_l,
                                 chroma_qp_off=chroma_qp_off)
        recs.append(reconstruct_picture(batch, 0, stackY, stackU, stackV,
                                        band_intra[i], gw=gw, gh=gh_l))
    ys, uvs = [], []
    for i, (y, u, v) in enumerate(recs):
        for ring, p in zip(rings, (y, u, v)):
            ring[i][wslot] = p
        ys.append(y.to(torch.uint8))
        uvs.append(torch.stack([u, v], dim=1).reshape(H // 2, W)
                   .to(torch.uint8))
    return (tuple(ys), tuple(uvs), *rings)


def _first_mb_is_zero(nal: bytes) -> bool:
    from hartallo_tpu_torch.bitio import BitReader, strip_emulation_prevention
    r = BitReader(strip_emulation_prevention(nal))
    r.u(8)                                     # NAL header
    return r.ue() == 0                         # first_mb_in_slice


def split_gops(stream: bytes):
    """IDR-cut a stream into self-contained GOP byte ranges, each
    prefixed with the SPS/PPS NALs (the GOP-across-hosts unit —
    SURVEY.md §2.4 row 7 / BASELINE config 5)."""
    from hartallo_tpu_torch.bitio import find_nal_units
    headers = b""
    gops = []
    cur = b""
    for s0, e0 in find_nal_units(stream):
        nal = stream[s0:e0]
        t = nal[0] & 0x1F
        chunk = b"\x00\x00\x00\x01" + nal
        if t in (7, 8, 15):                    # SPS/PPS/subset-SPS
            headers += chunk
        elif t == 5 and _first_mb_is_zero(nal):
            # IDR picture start (first slice only — multi-slice frames
            # carry one IDR NAL per slice): new GOP
            if cur:
                gops.append(cur)
            cur = headers + chunk
        else:
            cur += chunk
    if cur:
        gops.append(cur)
    return gops


def decode_gops_grouped(mesh: Mesh, stream: bytes, groups: int):
    """GOP pipeline: IDR-cut the stream and decode GOP g on the
    device group g % groups (``len(mesh.devices) // groups`` devices
    each), every picture row-sharded over the group
    (``decode_frame_step_sharded``).  The GOPs run one after another;
    returns the frames (packed I420 numpy) in stream order."""
    per = len(mesh.devices) // groups
    submeshes = [Mesh(mesh.devices[g * per:(g + 1) * per])
                 for g in range(groups)]
    return [f for g, gop in enumerate(split_gops(stream))
            for f in _decode_gop_sharded(submeshes[g % groups], gop)]


class ShardedDecoder(Decoder):
    """A ``Decoder`` whose batched pictures decode one at a time through
    ``decode_frame_step_sharded`` on ``mesh`` (band 0's device holds the
    host-facing output); the band rings stay on their devices between
    pictures."""

    dense_packed = True

    def __init__(self, mesh: Mesh):
        super().__init__(device=mesh.devices[0], batch_k=1)
        self.mesh = mesh
        self.rings = None

    def _flush(self, layer) -> None:
        jobs, layer.jobs = layer.jobs, []
        for job in jobs:
            gw, gh, S, cqoff = layer.ring_key
            if self.rings is None:
                n, H, W = len(self.mesh.devices), gh * 16, gw * 16
                self.rings = tuple(
                    tuple(torch.zeros((S, h // n, w), dtype=torch.int32,
                                      device=d) for d in self.mesh.devices)
                    for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2)))
            y, uv, *self.rings = decode_frame_step_sharded(
                self.mesh, job.packed, *self.rings, job.wslot, gw=gw, gh=gh,
                chroma_qp_off=cqoff, has_intra=job.has_intra, S=S)
            job.out = (_BatchOut(torch.cat([gather(y, self.device),
                                            gather(uv, self.device)])[None]),
                       0)


def _decode_gop_sharded(mesh: Mesh, gop_stream: bytes):
    """Decode one GOP with every picture row-sharded over ``mesh``."""
    res = ShardedDecoder(mesh).decode_annexb(gop_stream, tolerant=False)
    return [r.frame for r in res]
