"""Drive the PyTorch port of the codec on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. stop at once when torch sees no CUDA device; print the card's name
   and power limit (``nvidia-smi``);
2. build the CUDA kernels from the seven sources of
   ``hartallo_tpu_torch/csrc`` into ``build/kernels/`` (one ``nvcc`` per
   source, all at once) and print
   ptxas' registers and spills, and the intra encode kernel's dynamic
   shared memory, registers, spills, block size and the most MB rows
   (blocks) the card holds at once, and both motion search kernels'
   registers, spills, shared memory, block size and grid at 1080p, and
   the four P body kernels' registers, spills, shared memory and block
   size, as the runtime reports them, and how many byte-SIMD
   instructions (VABSDIFF4, IDP.4A) ``cuobjdump`` finds in the full
   search kernel's SASS (a SASS with none fails the run); the
   port's native slice parser and packer
   (``hartallo_tpu_torch/native``, built with gcc into ``build/native/``)
   must have loaded, or the timed host path would be pure Python;
3. GOP kernel phase: the ``d_pool.pack_fast`` payloads of the 16 pictures
   of ``tests/data/port/cif_16.264`` (stages m, mr, mri, mriwdsoh) and of
   the IDR picture of ``720p_8.264`` (3,600 intra MBs; stages mri and
   mriwdsoh), on a seeded synthetic ring, go through the whole-GOP decode
   kernel and its plain torch version on the card; outputs and ring slots
   must be byte-equal;
4. deblock kernel phase: seeded planes, bS in 0..4, QPs and nonzero
   alpha/beta offsets at the CIF, 4CIF, 720p and 1080p MB grids, at
   the 720p grid with slice-edge (idc 2) and idc 1 filter flags, and at
   the shard phase's 1080p band grids (120x17, 120x34 with the flags),
   go through the frame deblock kernel and its plain twin; the planes
   must be byte-equal;
5. intra encode kernel phase: the first ``bench.make_clip`` frame at
   one MB, QCIF, CIF, 4CIF, 720p and 1080p, the CIF, 720p and 1080p
   grids in the masked (intra-in-P) form with seeded base planes, CIF in
   three row slices, a flat CIF picture, CIF with per-MB qp over 0..51 at
   chroma offsets -4 and +5 and the lambdas of qp 12 and 45, a tall
   narrow picture (352x1088, 68 MB rows of 22) and a picture of one MB
   row (1920x16) (INTRA_CASES) go through the kernel (one block per MB
   row) and its plain twin; all eleven outputs must be equal;
6. ME kernel phase: the ``bench.make_clip`` frame pair (the second frame
   searched in the first) at one MB, QCIF, CIF, 4CIF, 720p and 1080p, the
   shard phase's 1080p band of 17 MB rows with its halo reference, ranges
   1, 5, 12 and 24 and the lambdas of qp 12, 30 and 45 (ME_CASES) go
   through the full search kernel and its plain twin (all eight outputs
   equal), then seeded MVs and partition maps through the refinement:
   one-round launches (the half-pel round, then the quarter-pel round on
   its result) against the twin's rounds, and the two-round launch
   against the twin's chain, also on the MVs and partition map the path
   derives from the search (MVs and costs equal);
6b. P body kernel phase: the ``bench.make_clip`` frame pair's Y, U and V
   planes at one MB, QCIF, CIF, 4CIF, 720p and 1080p, the shard phase's
   1080p band of 17 MB rows with its halo reference planes, qp 0 with
   chroma offset -4, qp 51 with +5, per-MB qp over 0..51 with seeded
   slice-edge flags, seeded MVs up to 100 pels into the pad at every
   edge, an intra-heavy and a flat source (P_CASES) go through the
   path's chain (the full search kernel, then the partition decision,
   the half-pel stack, the refinement kernel, the residual and the
   deblock parameters), each of the four P body kernels held against its
   plain twin on the same inputs, every output equal;
6c. decode kernels phase: the decoder's intra wavefront kernel
   (``intra_decode.cu``) and deblock parameter kernel
   (``k_deblock_params_dec`` of ``deblock.cu``) against their plain twins
   on seeded inputs at one MB, QCIF (with inter and I_BL MBs), CIF (also
   constrained intra over three slices with the above-right flags false
   on a row, intra MBs under intra MBs above-right with inter MBs
   between, and all inter), 720p, 1080p (also with one intra MB in 50)
   and the shard phase's 120x34 band (INTRA_DEC_CASES), the parameters
   on int16 records (the general route's, ``pack_deblock_record``), also
   on 5 QCIF pictures a launch and in the GOP scan's dense buffer;
   every output equal;
6d. GOP scan kernels phase: the residual (``k_residual_dec``), MC
   (``k_mc_dec``) and ring write (``k_ring_write_dec``) kernels of
   ``mc_decode.cu`` against their plain twins at QCIF, CIF, 720p, 1080p
   and the shard phase's 120x34 band (MC_DEC_CASES): the residual on two
   pictures a launch of int16 records with qp 0..51, Intra16x16 MBs and
   int16-extreme coefficients at chroma QP offsets -12, 0 and +12, on
   each of RESIDUAL_SETS (no luma block coded, 15%, all, each MB its
   own, stray levels where TotalCoeff is 0; each set's coded fraction
   printed); the MC on three
   slots with per-4x4 MVs up to 2,000 quarter pels outside the picture,
   and again with coherent motion (one MV an MB), and weights with logWD
   0..7, from the scan's uint8 ring and, at the band, the int32 stacks;
   the ring write on noisy rings; every output equal;
6e. upload phase: first ``pinned_reuse_check`` (PyTorch's caching host
   allocator holds a page-locked buffer while a copy from it is queued,
   which ``decode/staging.py`` rests on); then ``1080p_8_wp``'s scan
   batch (7 pictures of int16 rows) copied from the page-locked host
   buffer to the card with one asynchronous copy
   (``decode/staging.RowStaging``), in ms and GB/s;
7. decode slice phase (the decode path): ``Codec(CodecConfig())``, on
   its default device, the card, decodes the CIF, 720p and 1080p
   fixtures, launch counts set to 0 just before; every frame's MD5 must
   equal the one the JAX package recorded, every picture must take the
   GOP kernel, and none of the decoder's other kernels may run;
8. scan phase (the GOP-scan route), launch counts set to 0 just before
   each fixture: the weighted-prediction fixtures ``qcif_6_wp``,
   ``720p_8_wp`` and ``1080p_8_wp`` decode to their MD5s with 1 kernel
   picture and 5, 7 and 7 scan pictures: one residual and one deblock
   parameter launch for each scan batch, an MC, a deblock and a ring
   write launch for each scan picture, an intra wavefront launch for
   each scan picture with an intra MB, no half-pel stack (qcif_6_wp: 1,
   5, 5 and 1), every call held against its plain twin;
8b. general phase (the general route), launch counts set to 0 just
   before it: ``qcif_6_sl`` (scaling lists) and ``pcm_64x48`` (PCM MBs)
   decode to their MD5s with every picture on the general route; the
   intra wavefront kernel must have run once per picture with an
   Intra4x4 or Intra16x16 MB, the deblock parameter kernel and the
   deblock kernel once per picture with an MB edge to filter (both
   counted from the parsed pictures, ``DecodeWork``), at least one
   intra wavefront launch in all, no half-pel stack and no GOP kernel;
   every call held against its plain twin;
9. encode phase (the encode path): ``Codec(CodecConfig(W, H, qp=30,
   gop_size=NF, deblock=True, me_range=12)).encode_frames`` of
   ``bench.make_clip`` at CIF 16, 720p 8 and 1080p 8 on the card, launch
   counts set to 0 just before; each stream must equal the JAX package's
   fixture byte for byte, the deblock kernel must have run once per
   picture, the intra kernel once for the IDR picture and once for each
   P picture that took the intra-in-P branch, the full search kernel,
   the partition decision, the half-pel stack, the refinement kernel
   (both rounds) and the residual kernel once each per P picture, the
   deblock parameters kernel once per picture, and the port's decoder
   must decode the port's streams to the recorded MD5s; then
   ``torch.profiler`` lists the device kernels of one CIF P picture, the
   hand kernels apart from the rest;
10. SVC phase (the SVC round trip), launch counts set to 0 just before
   it: the three layers of ``svc3_4cif_8`` (176x144, 352x288 and
   704x576, 8 pictures each, two temporal layers; the 4CIF
   ``bench.make_clip`` and its dyadic downsamplings) are encoded through
   ``Codec.encode`` on the card, byte-equal to the JAX package's fixture;
   the fixture decodes to its MD5s for every DQId, and so do its
   ``dqid_max=0`` and ``tid_max=0`` decodes; the GOP kernel must have run
   once per kernel-route picture, the deblock kernel once per encoded
   picture of every layer and once per general-route picture of the
   decodes, the decoder's deblock parameter kernel once per
   general-route picture with an MB edge to filter and its intra
   wavefront kernel once per general-route picture with an Intra4x4 or
   Intra16x16 MB (``DecodeWork``), the intra kernel once per base-layer
   IDR picture, the
   refinement kernel once per full search, the partition decision and the
   residual kernel once per full search, the half-pel stack once per
   refinement, the deblock parameters once per encoded picture; in the
   encode and the full decode every call of any kernel is held against
   its plain twin on the same inputs, at the path's own shapes (QCIF,
   CIF and 4CIF), tolerance 0;
10b. ILP phase, launch counts set to 0 just before it: ``svc_quality_4``
   (a QCIF layer and its quality refinement layer, 4 pictures) encoded
   through ``Codec.encode`` byte-equal to its fixture, the inter-layer
   prediction's MC kernel and half-pel stack once for each refined P
   picture (3), every kernel call held against its plain twin;
11. shard phase (the row-sharded path), launch counts set to 0 just
   before it, on ``Mesh(("cuda:0",) * 4)``: the 1080p P step
   (``p_encode_step_sharded``, four bands of 17 MB rows) must give the
   eight outputs whose MD5s the JAX package recorded
   (``shard_p_1080p.json``) with 4 deblock, 4 full search, 4
   refinement and 4 of each P body kernel launches, and
   ``decode_gops_grouped`` of ``shard_1080p_8`` with 2 groups (two
   bands of 34 MB rows each) every frame's MD5 with 16 deblock and 16
   deblock parameter kernel launches, an intra wavefront launch for each
   band picture with an Intra4x4 or Intra16x16 MB (``DecodeWork``, at
   least one), 16 residual and 16 MC launches and no ring write, a
   half-pel stack launch for each ring
   slot of each band picture, and none of the GOP kernel; every kernel
   call of both is held against its plain twin, tolerance 0 (in the
   scan, SVC and shard phases the deblock and intra wavefront twins
   replay as CUDA graphs of their own ops where their input shapes
   recur: ``ops/graphs.replayed``);
12. timings (not claims), CUDA events for kernels and host clocks around
   synchronised runs: kernel and plain time per CIF picture and the
   kernel's time on the 720p IDR picture; per deblocked frame, the
   wrapper with its parameter gather, the launch alone and the plain
   twin; the intra encode kernel per picture at one MB, CIF, 720p and
   1080p, with its wrapper and alone (the profiler's device time, each
   launch after an L2 flush, the median: ``kernel_us``), beside its
   chain floor (the gw + 2 gh - 2 MBs of its critical path
   times the one-MB picture's kernel time), the twin at CIF and 720p
   (each twin timed on its check run); the full search and the two-round
   refinement launch per picture at CIF, 720p and 1080p, with the
   wrapper (CUDA events), alone (the profiler's device time) and the
   wrapper's host time per call (no sync), beside their twins; the four
   P body kernels per picture at CIF, 720p and 1080p the same way, after
   the launch floor (the profiler's device time of a one-element fill);
   the decoder's intra wavefront and deblock parameter kernels per
   picture at CIF, 720p, 1080p, the 120x34 band and the 1080p picture
   with one intra MB in 50 with their wrappers and alone, the wavefront
   at the all-intra sizes beside its chain model gw s + (gh - 1)(2 s +
   h), with the in-row step s and the row-to-row hand-off h from the
   times of a 120x1 and a 1x68 picture less the launch floor; the GOP
   scan's residual, MC and ring write kernels per picture at CIF, 720p,
   1080p and the band with their wrappers and alone; each
   beside its bound (the residual's and the parameters' also beside
   their bounds as counted on int32 records, before the int16 upload)
   (``gop_bound``, ``deblock_bound``, ``intra_bound``, ``me_bound``,
   ``p_bound``, ``intra_dec_bound``, ``params_dec_bound``,
   ``residual_dec_bound``, ``mc_dec_bound``, ``ring_write_bound``);
   encode fps at CIF, 720p and
   1080p, decode fps at CIF, 720p and 1080p, the SVC
   clip's encode and decode rates, ms per sharded 1080p P step on four
   bands and on one, and the sharded decode's frames/s beside
   ``Codec.decode_annexb`` of the same stream, best and worst of 3 after
   a warm-up (for the encodes and the four-band runs, the encode, SVC
   and shard phases' runs).

Then one JSON object describing the fourteen kernels, the card's name and
power limit, and as the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
FIXTURES = REPO / "tests" / "data" / "port"
STAGES = ("m", "mr", "mri", "mriwdsoh")
SEED = 1234
# the deblock grids: CIF, 4CIF (the SVC clip's top layer), 720p, 1080p
# (1088 coded rows), 720p with slice-edge and idc 1 filter flags, and the
# shard phase's band grids (a quarter and a half of 1080p's MB rows)
DEBLOCK_GRIDS = (("CIF", 22, 18, False), ("4CIF", 44, 36, False),
                 ("720p", 80, 45, False), ("1080p", 120, 68, False),
                 ("720p slices", 80, 45, True),
                 ("1080p band of 17 rows", 120, 17, False),
                 ("1080p band of 34 rows", 120, 34, True))
# the intra encode kernel's cases: (label, width, height, options of
# intra_inputs); the defaults are bench.py's settings (qp 30,
# chroma_qp_index_offset 0, the lambda of qp 30, one slice)
INTRA_CASES = (
    ("QCIF", 176, 144, {}), ("CIF", 352, 288, {}), ("4CIF", 704, 576, {}),
    ("720p", 1280, 720, {}), ("1080p", 1920, 1080, {}),
    ("CIF masked", 352, 288, {"masked": True}),
    ("720p masked", 1280, 720, {"masked": True}),
    ("CIF 3 slices", 352, 288, {"slices": 3}),
    ("CIF flat", 352, 288, {"flat": True}),
    ("CIF qp 0..51, offset -4, lambda of qp 12", 352, 288,
     {"qp": None, "cqo": -4, "lam_qp": 12}),
    ("CIF qp 0..51, offset +5, lambda of qp 45", 352, 288,
     {"qp": None, "cqo": 5, "lam_qp": 45}),
    ("1080p masked", 1920, 1080, {"masked": True}),
    ("352x1088, 68 rows of 22 MBs", 352, 1088, {}),
    ("1920x16, one MB row", 1920, 16, {}),
    ("one MB", 16, 16, {}))
# timed per picture; "one MB" gives one MB's latency, the unit of the
# chain floor
INTRA_TIMED = ("one MB", "CIF", "720p", "1080p")
# the motion search kernels' cases: (label, width, height, options of
# me_inputs); the defaults are bench.py's settings (me_range 12, the
# lambda of qp 30); the band is the shard phase's second band of 17 MB
# rows with its halo reference; range 24 is the encoder's largest
# (encoder.py clamps me_range to PAD - 8); 4CIF's 44 MBs a row end in a
# short strip of the full search's 8
ME_CASES = (
    ("QCIF", 176, 144, {}), ("CIF", 352, 288, {}), ("4CIF", 704, 576, {}),
    ("720p", 1280, 720, {}), ("1080p", 1920, 1080, {}),
    ("1080p band of 17 rows, halo reference", 1920, 1080, {"band": True}),
    ("CIF range 5, lambda of qp 12", 352, 288, {"rng": 5, "lam_qp": 12}),
    ("CIF lambda of qp 45", 352, 288, {"lam_qp": 45}),
    ("720p range 5, lambda of qp 45", 1280, 720, {"rng": 5, "lam_qp": 45}),
    ("1080p lambda of qp 12", 1920, 1080, {"lam_qp": 12}),
    ("720p range 24", 1280, 720, {"rng": 24}),
    ("one MB", 16, 16, {}),
    ("CIF range 1", 352, 288, {"rng": 1}))
ME_TIMED = ("CIF", "720p", "1080p")
# the P-picture body kernels' cases: (label, width, height, options of
# p_inputs); the defaults are bench.py's settings (qp 30,
# chroma_qp_index_offset 0, the lambda of qp 30, me_range 12); the band is
# the shard phase's second band of 17 MB rows with its halo reference
P_CASES = (
    ("one MB", 16, 16, {}), ("QCIF", 176, 144, {}), ("CIF", 352, 288, {}),
    ("4CIF", 704, 576, {}), ("720p", 1280, 720, {}),
    ("1080p", 1920, 1080, {}),
    ("1080p band of 17 rows, halo reference", 1920, 1080, {"band": True}),
    ("CIF qp 0, offset -4", 352, 288, {"qp": 0, "cqo": -4}),
    ("CIF qp 51, offset +5", 352, 288, {"qp": 51, "cqo": 5}),
    ("CIF qp 0..51, slice-edge flags", 352, 288, {"qp": None,
                                                  "flags": True}),
    ("CIF MVs into the pad at every edge", 352, 288, {"mv_max": 400}),
    ("CIF intra-heavy", 352, 288, {"intra": True}),
    ("CIF flat", 352, 288, {"flat": True}))
P_TIMED = ("CIF", "720p", "1080p")
# NVIDIA's data sheet for the H100 SXM at 700 W: HBM3 rate, and the
# float32 rate outside the tensor cores, the nearest published rate for
# the kernels' int32 arithmetic (their integer rate is no higher, so the
# bound stays a lower bound)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# Hopper's integer pipes: 64 int32 lanes a clock on each SM; a byte-SIMD
# instruction (VABSDIFF4, IDP.4A) takes four samples a lane
H100_SMS = 132
INT32_LANES_PER_SM = 64


def bound(nbytes: float, ops: float, ops_per_s: float = SCALAR_OPS_PER_S):
    """(ms, "bytes" or "operations"): the least time the card could take
    to move ``nbytes`` and do ``ops`` at ``ops_per_s``."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def sm_clock_hz() -> float:
    """The card's highest SM clock, ``nvidia-smi``'s clocks.max.sm."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0]
    return float(out) * 1e6


def gop_bound(pay, gw: int, gh: int):
    """Bound of the GOP kernel per picture of the numpy payload ``pay``:
    each picture's payload rows in use, one reference sample per
    predicted sample of its inter MBs, the ring slot and the output it
    writes; operations: the half-pel filters, 18 multiply-adds per
    padded luma sample (b and h from G, j from b)."""
    H, W, nmb = gh * 16, gw * 16, gw * gh
    Hp, Wp, Hcp, Wcp = H + 64, W + 64, H // 2 + 64, W // 2 + 64
    K = pay["sf"].shape[0]
    nbytes = ops = 0
    for k in range(K):
        nr, ni = int(pay["sf"][k, 4]), int(pay["sf"][k, 5])
        nbytes += pay["smb"][k].nbytes + pay["aux"][k].nbytes + \
            pay["sf"][k].nbytes + nr * (4 + 16 * 2) + ni * (16 + 24 * 16 * 2)
        nbytes += (nmb - ni) * 384
        nbytes += 4 * Hp * Wp + 2 * Hcp * Wcp + (H + H // 2) * W
        ops += 36 * Hp * Wp
    ms, by = bound(nbytes, ops)
    return ms / K, by


def deblock_bound(planes, rest):
    """Bound of one ``deblock_frame_fast`` call on numpy inputs: the
    planes read and written, the bS and QP maps read; operations: about
    30 per line through an edge with bS > 0 (4 luma lines per bS entry,
    2 lines of each chroma plane per entry of luma edges 0 and 2)."""
    bs_v, bs_h = rest[0], rest[1]
    nbytes = 2 * sum(p.nbytes for p in planes) + sum(a.nbytes for a in rest)
    lines = sum(4 * int((b > 0).sum()) + 4 * int((b[:, :, 0::2] > 0).sum())
                for b in (bs_v, bs_h))
    return bound(nbytes, 30 * lines)


def intra_bound(gw: int, gh: int, masked: bool):
    """Bound of one ``intra_encode_frame_fast`` call: the int32 source
    interiors (and the base recon's in the masked form) read, the recon
    interiors and the 427 int32 words of arrays per MB written, the qp
    and flag maps read; operations: 3 per candidate sample (difference,
    absolute value, sum) of the 4 Intra16x16, 9 Intra4x4 and 4 chroma
    predictions."""
    samples = gw * gh * 384
    nbytes = 4 * samples * (3 if masked else 2) + gw * gh * (427 * 4 + 9)
    return bound(nbytes, 3 * (4 * 256 + 9 * 256 + 4 * 128) * gw * gh)


def me_bound(gw: int, gh: int, rng: int, kernel: str, clock_hz: float):
    """Bound of one ``full_search_int_fast`` call or one two-round
    ``refine_subpel_rounds_fast`` launch, the least the card could take
    whatever implements it.  Full search: bytes, the int32 source
    interior and the reference window of the picture ((H + 2R) x (W +
    2R)) read, 9 costs and MVs per MB written; operations, the (2R+1)^2
    H W candidate samples at four a lane-instruction (byte SIMD) on
    ``INT32_LANES_PER_SM`` lanes a clock of each SM at ``clock_hz`` (it
    assumes no instruction does more than four samples' absolute
    differences and sums, and counts nothing else).  Refinement: bytes,
    the int32 source interior and the four half-pel planes over the
    picture read once, the MVs and the partition map read, the final MVs
    and 4 costs per MB written; operations, 10 per sample and delta of
    each of the two rounds (the two-tap average 3, the difference 1, two
    Hadamard butterfly stages 4, the absolute value and the sum 2) at
    the float32 rate."""
    H, W, nmb = gh * 16, gw * 16, gw * gh
    if kernel == "full_search":
        nbytes = 4 * H * W + 4 * (H + 2 * rng) * (W + 2 * rng) + \
            nmb * 9 * (4 + 8)
        return bound(nbytes, (2 * rng + 1) ** 2 * H * W,
                     4 * INT32_LANES_PER_SM * H100_SMS * clock_hz)
    nbytes = 4 * H * W * 5 + nmb * (2 * 16 * 2 * 4 + 16 * 4 + 4 * 4)
    return bound(nbytes, 2 * 9 * H * W * 10)


def sass_simd(lib, kernel: str):
    """How many VABSDIFF4 and IDP.4A instructions ``cuobjdump -sass``
    finds in the SASS of the kernels of ``lib`` whose names hold
    ``kernel``, or None where the toolkit has no cuobjdump."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(tool).exists():
        return None
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    counts = dict.fromkeys(("VABSDIFF4", "IDP.4A"), 0)
    inside = False
    for line in text.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside:
            for op in counts:
                counts[op] += f" {op}" in line
    return counts


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def frame_md5(frame) -> str:
    """MD5 of a decoded frame's bytes, as the fixtures record it."""
    return hashlib.md5(frame.astype("uint8").tobytes()).hexdigest()


def load_fixture(name):
    meta = json.loads((FIXTURES / f"{name}.json").read_text())
    return (FIXTURES / f"{name}.264").read_bytes(), meta


def fast_frames(name: str, device):
    """Parse a fixture with the port's decoder and return the kernel
    payloads of its pictures and its geometry (nothing is decoded)."""
    from hartallo_tpu_torch.decode.decoder import Decoder
    dec = Decoder(device=device, batch_k=1 << 30)
    dec.enqueue_annexb(load_fixture(name)[0], tolerant=False)
    jobs = dec.layer.jobs
    if any(j.fast is None for j in jobs):
        raise SystemExit(f"kernel phase: a {name} picture is not eligible")
    gw, gh, S, _ = dec.layer.ring_key
    return [j.fast for j in jobs], gw, gh, S


def event_ms(torch, fn, reps, warm=True):
    """Mean ms of fn() over reps calls after one warm-up (none with
    ``warm`` False), CUDA events."""
    if warm:
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


_L2_FLUSH = []


def l2_flush(torch):
    """Read a 128 MiB buffer on the card (2.5 times the H100's 50 MB L2),
    so that the next kernel reads its inputs from HBM, not from the L2
    that its previous call left warm, and finds the L2 holding clean
    lines (a flush that writes leaves dirty lines, whose write-back the
    next kernel would pay: 5-8 µs more at 1080p on an H100)."""
    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.empty(32 << 20, dtype=torch.int32,
                                     device="cuda"))
    _L2_FLUSH[0].sum()


def kernel_us(torch, fn, reps: int, name: str, launches: int = 1,
              lead_in: int = 32):
    """Device time in µs per call of fn(), which launches the kernel whose
    name holds ``name`` ``launches`` times: the median of its launches
    over reps calls after one warm-up, each call after ``l2_flush`` (a
    cold L2, as the bytes bounds assume), from ``torch.profiler``'s
    device-side records (no host time: for a kernel that the host's
    set-up outlasts), times ``launches``; None when the trace holds none.

    Only launches made inside the profiled window count, each once: a
    device record is kept when a runtime launch call of the window
    carries its correlation id (where the trace pairs any record with
    such a call), and a launch's time is the span from the first to the
    last of its records.  A mean over ``key_averages()`` would also take
    in a record of the name that the window did not launch, and count a
    launch split into several records more than once.  A trace can lose
    the device records of a window's first launches (in the smoke on an
    H100, those of its first 5-11 launch calls, after 20 ms of idle host
    too), so the window opens with ``lead_in`` flushes and a
    synchronize.  Where the launches kept are not ``reps * launches``,
    or a record was not paired, a line says so and gives the kept
    launches' places among the window's launch calls (1 the first)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    l2_flush(torch)
    torch.cuda.synchronize()
    for _ in range(3):           # a trace now and then comes back empty
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(lead_in):
                l2_flush(torch)
            torch.cuda.synchronize()
            for _ in range(reps):
                l2_flush(torch)
                fn()
            torch.cuda.synchronize()
        events = prof.events()
        calls = sorted((e.time_range.start, e.id) for e in events
                       if e.device_type == DeviceType.CPU
                       and "Launch" in e.name)
        place = {cid: i + 1 for i, (_, cid) in enumerate(calls)}
        records = [e for e in events if e.device_type == DeviceType.CUDA
                   and name in e.name]
        seen = len(records)
        if place.keys() & {e.id for e in records}:
            records = [e for e in records if e.id in place]
        spans = {}
        for e in records:
            t0, t1 = spans.get(e.id, (e.time_range.start, e.time_range.end))
            spans[e.id] = (min(t0, e.time_range.start),
                           max(t1, e.time_range.end))
        if spans:
            if len(spans) != reps * launches or seen != len(spans):
                kept = sorted(place.get(i, 0) for i in spans)
                print(f"kernel_us {name}: {len(spans)} launches kept of "
                      f"{reps * launches} made, from {len(records)} of the "
                      f"{seen} device records in the trace ({len(calls)} "
                      f"launch calls in it; the kept at places {kept})",
                      flush=True)
            times = sorted(t1 - t0 for t0, t1 in spans.values())
            n = len(times)
            return launches * (times[n // 2] + times[(n - 1) // 2]) / 2
    return None


def launch_floor_us(torch):
    """The profiler's device time in µs of a one-element fill on the card:
    the least a launch takes, which the short kernels are read against.
    Read once more first without ``kernel_us``' lead-in, whose line shows
    what the trace loses then."""
    one = torch.zeros(1, device="cuda")
    kernel_us(torch, lambda: one.fill_(1.0), 20, "FillFunctor", lead_in=0)
    return kernel_us(torch, lambda: one.fill_(1.0), 20, "FillFunctor")


def host_us(fn, reps: int) -> float:
    """Host time in µs per call of fn() (``time.perf_counter``, no sync:
    what the wrapper costs the host before the card runs it), over reps
    calls after one warm-up."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def check_gop(torch, frames, gw, gh, S, stages_list, label):
    """The GOP kernel against its plain twin on the card for each stage
    set, on a seeded ring; returns (max_abs_err, numpy payload, the
    kernel's arguments, a fresh-ring maker and the twin's ms per call of
    the last stage set, timed on its check run)."""
    from hartallo_tpu_torch.decode import d_gop_fast as F
    from hartallo_tpu_torch.decode.d_gop import ring_shapes
    import numpy as np

    host = F.stack_payload(frames)
    pay = F.payload_to(host, "cuda")
    rng = np.random.default_rng(SEED)
    ring0 = tuple(rng.integers(0, 256, s, dtype=np.uint8)
                  for s in ring_shapes(gw, gh, S))
    Hp, Wp = gh * 16 + 64, gw * 16 + 64
    Hcp, Wcp = gh * 8 + 64, gw * 8 + 64
    args = [pay[k] for k in ("smb", "aux", "sf", "tags", "vals", "ilist",
                             "ivals")]
    max_err = 0
    for stages in stages_list:
        rk = F.rings_from_numpy(*ring0, "cuda")
        rp = F.rings_from_numpy(*ring0, "cuda")
        ok_, *rk = F.decode_gop_fast(*args, *rk, gw=gw, gh=gh,
                                     stages=stages)
        plain = []
        plain_ms = event_ms(torch, lambda: plain.append(
            F.decode_gop_fast_plain(*args, *rp, gw=gw, gh=gh,
                                    stages=stages)), 1, warm=False)
        op, *rp = plain[0]
        err = int((ok_.int() - op.int()).abs().max())
        same = torch.equal(ok_, op) and \
            torch.equal(rk[0][:, :, :Hp, :Wp], rp[0][:, :, :Hp, :Wp]) and \
            all(torch.equal(a[:, :Hcp, :Wcp], b[:, :Hcp, :Wcp])
                for a, b in zip(rk[1:], rp[1:]))
        print(f"kernel phase {label} stages={stages}: byte-equal={same} "
              f"max_abs_err={err}", flush=True)
        if not same:
            raise SystemExit(f"kernel != plain for {label}, stages {stages}")
        max_err = max(max_err, err)
    return (max_err, host, args,
            lambda: F.rings_from_numpy(*ring0, "cuda"), plain_ms)


def kernel_phase(torch, card):
    """The GOP kernel against its twin: the 16 pictures of cif_16 at every
    stage set, and the IDR picture of 720p_8 (3,600 intra MBs) at mri and
    mriwdsoh; then kernel and twin times per CIF picture (the twin's from
    its mriwdsoh check run) and the kernel's time on the 720p IDR
    picture."""
    from hartallo_tpu_torch.decode import d_gop_fast as F

    frames, gw, gh, S = fast_frames("cif_16", "cuda")
    err, host, args, rings, plain_ms = check_gop(torch, frames, gw, gh, S,
                                                 STAGES, "cif_16")
    hd, hgw, hgh, hS = fast_frames("720p_8", "cuda")
    hd_err, _, hd_args, hd_rings, _ = check_gop(
        torch, hd[:1], hgw, hgh, hS, ("mri", "mriwdsoh"), "720p_8 IDR")
    K = len(frames)
    plain_ms /= K
    rk, rh = rings(), hd_rings()
    ms = event_ms(torch, lambda: F.decode_gop_fast(*args, *rk, gw=gw,
                                                   gh=gh), 10) / K
    hd_ms = event_ms(torch, lambda: F.decode_gop_fast(
        *hd_args, *rh, gw=hgw, gh=hgh), 3)
    bound_ms, bound_by = gop_bound(host, gw, gh)
    print(f"[{card}] GOP kernel: CIF {ms * 1e3:.1f} us/picture, plain torch "
          f"{plain_ms * 1e3:.1f} us/picture ({K} pictures per call), bound "
          f"{bound_ms * 1e3:.3f} us/picture ({bound_by}); 720p IDR picture "
          f"{hd_ms * 1e3:.1f} us", flush=True)
    return max(err, hd_err), ms, plain_ms, bound_ms, bound_by


def deblock_inputs(gw, gh, seed, flags=False):
    """Seeded planes, bS in 0..4 (picture edges 0, as every caller keeps
    them), QPs and nonzero alpha/beta offsets, as numpy int32: the inputs
    of tests/test_deblock_pallas.py.  With ``flags``, the filter flags of
    slices of a few MB rows: no filtering across every other slice edge
    (disable_deblocking_filter_idc 2: bS 0 on the top edge of the slice's
    first row) and none at all in some MBs (idc 1)."""
    import numpy as np
    H, W = gh * 16, gw * 16
    rng = np.random.default_rng(seed)
    planes = tuple(rng.integers(0, 256, (h + 64, w + 64)).astype(np.int32)
                   for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2)))
    bs_v = rng.integers(0, 5, (gh, gw, 4, 4)).astype(np.int32)
    bs_h = rng.integers(0, 5, (gh, gw, 4, 4)).astype(np.int32)
    bs_v[:, 0, 0] = 0
    bs_h[0, :, 0] = 0
    rest = (bs_v, bs_h,
            *[rng.integers(10, 50, (gh, gw)).astype(np.int32)
              for _ in range(3)],
            *[rng.integers(10, 40, (gh, gw)).astype(np.int32)
              for _ in range(3)],
            (rng.integers(-4, 5, (gh, gw)) * 2).astype(np.int32),
            (rng.integers(-4, 5, (gh, gw)) * 2).astype(np.int32))
    if flags:
        first = np.sort(rng.choice(np.arange(1, gh), gh // 3,
                                   replace=False))
        bs_h[first[::2], :, 0] = 0
        off = rng.random((gh, gw)) < 0.1
        bs_v[off] = 0
        bs_h[off] = 0
    return planes, rest


def deblock_rec_inputs(gw: int, gh: int, K: int, seed: int, wide=False,
                       edge_flags=False):
    """Seeded per-MB records of K pictures, (K, gh*gw, words) int16 numpy,
    and the offsets of ``deblock_fast.DEBLOCK_FIELDS`` in them: kinds of
    every class (I4x4, I16, PCM, P ones, I_BL), qp 0..51, MVs in -9..9
    quarter pels (so that neighbours differ by 4 or more and less),
    refIdx 0..2 a quadrant (so they differ across some edges), TotalCoeff
    0..3 with half of them 0, per-MB alpha/beta offsets in -12..12, the
    MB edge flags of slices of a few rows (no filtering across every other
    slice edge, disable_deblocking_filter_idc 2) and none at all in some
    MBs (idc 1), with ``edge_flags`` also column 0's and row 0's (the
    twin's wrap).  The record is the general route's
    (``deblock_fast.pack_deblock_record``) or, with ``wide``, the GOP
    scan's dense buffer (``d_fused.DEC_FIELDS``), its other words
    seeded."""
    import numpy as np
    from hartallo_tpu_torch.decode.d_fused import DEC_FIELDS
    from hartallo_tpu_torch.ops.deblock_fast import (DEBLOCK_FIELDS,
                                                     pack_deblock_record,
                                                     record_offsets)
    rng = np.random.default_rng(seed)
    recs = []
    for _ in range(K):
        kind = rng.choice(np.array([0, 1, 2, 3, 3, 4, 5, 8]), (gh, gw))
        sid = np.sort(rng.integers(0, 3, gh))[:, None].repeat(gw, 1)
        idc = rng.choice(np.array([0, 0, 0, 1, 2]), (gh, gw))
        fint = idc != 1
        fv = np.zeros((gh, gw), bool)
        fh = np.zeros((gh, gw), bool)
        fv[:, 1:] = fint[:, 1:] & ((idc[:, 1:] != 2) |
                                   (sid[:, 1:] == sid[:, :-1]))
        fh[1:] = fint[1:] & ((idc[1:] != 2) | (sid[1:] == sid[:-1]))
        if edge_flags:
            fv[:, 0] = rng.random(gh) < 0.5
            fh[0] = rng.random(gw) < 0.5
        nnz = rng.integers(0, 4, (gh, gw, 4, 4)) * \
            (rng.random((gh, gw, 4, 4)) < 0.5)
        vals = {"kind": kind, "qp": rng.integers(0, 52, (gh, gw)),
                "mv": rng.integers(-9, 10, (gh, gw, 4, 4, 2)),
                "ref_idx": rng.integers(0, 3, (gh, gw, 4)), "nnz": nnz,
                "alpha_off": rng.integers(-6, 7, (gh, gw)) * 2,
                "beta_off": rng.integers(-6, 7, (gh, gw)) * 2,
                "fmb_v": fv, "fmb_h": fh, "fint": fint}
        if not wide:
            recs.append(pack_deblock_record(vals, gw, gh))
            continue
        recs.append(np.concatenate([
            np.asarray(vals[name], np.int16).reshape(gh * gw, -1)
            if name in vals else
            rng.integers(-99, 100, (gh * gw, int(np.prod(shape, dtype=int))
                                    if shape else 1)).astype(np.int16)
            for name, shape in DEC_FIELDS], axis=1))
    return np.stack(recs), \
        record_offsets(DEC_FIELDS if wide else DEBLOCK_FIELDS)[0]


def _coeffs(rng, shape):
    """Seeded int16 coefficients: 40% zeros, most small, 7% anywhere in
    the int16 range and 3% at its ends (so that sums and shifts carry
    past int32, as torch's arithmetic wraps)."""
    import numpy as np
    pick = rng.random(shape)
    v = rng.integers(-40, 41, shape)
    v = np.where(pick < 0.4, 0, v)
    v = np.where((pick > 0.9) & (pick <= 0.97),
                 rng.integers(-32768, 32768, shape), v)
    return np.where(pick > 0.97, rng.choice(
        np.array([-32768, -32767, 32766, 32767]), shape), v)


# the fields of ``mc_decode_fast.RESIDUAL_FIELDS``, by name (the
# residual's seeded records are built without the package's list, so that
# tools/port_kernel_times.py can feed them to an older tree)
RESIDUAL_NAMES = ("luma_ac", "luma_dc", "chroma_ac", "chroma_dc", "qp",
                  "kind", "nnz")
# the residual's input sets (label, the fraction of luma blocks with
# levels (None: each MB 0, 15% or all of them), stray levels in uncoded
# blocks)
RESIDUAL_SETS = (("mixed", None, False), ("zero-coded", 0.0, False),
                 ("sparse", 0.15, False), ("fully coded", 1.0, False),
                 ("stray levels", None, True))


def residual_rec_inputs(gw: int, gh: int, K: int, seed: int, coded=None,
                        stray=False):
    """Seeded dense buffers of K pictures for ``residual_planes_fast``:
    (K, gh*gw, WORDS) int16 numpy of ``d_fused.DEC_FIELDS`` and the
    offsets of ``mc_decode_fast.RESIDUAL_FIELDS`` in them.  Kinds I4x4,
    I16 (a third), P ones and I_BL; qp 0 or 51 in a fifth of the MBs
    each, else 0..51.  A luma block has levels (``_coeffs``, one at least
    nonzero, TotalCoeff their count) with probability ``coded``, or with
    None 0, 0.15 or 1 as each MB draws (an I16 MB without levels is its
    DC alone); elsewhere its levels are 0 and its TotalCoeff 0, as the
    parser leaves them, or with ``stray`` seeded all the same (which the
    kernel and its twin ignore).  Half the chroma blocks and a third of
    the MBs' chroma DC are 0, the rest ``_coeffs``; the other words
    seeded."""
    import numpy as np
    from hartallo_tpu_torch.decode.d_fused import DEC_FIELDS
    from hartallo_tpu_torch.ops.deblock_fast import record_offsets
    rng = np.random.default_rng(seed)
    n = gh * gw
    offs, words = record_offsets(DEC_FIELDS,
                                 [(name, None) for name in RESIDUAL_NAMES])
    rec = rng.integers(-99, 100, (K, n, words)).astype(np.int16)
    la, ld, ca, cd, qp, kind, nz = offs
    frac = rng.choice(np.array([0.0, 0.15, 1.0]), (K, n, 1)) \
        if coded is None else np.full((K, n, 1), coded)
    on = rng.random((K, n, 16)) < frac                    # blkIdx order
    lac = _coeffs(rng, (K, n, 16, 16))
    lac[..., 0] = np.where(lac[..., 0] == 0, 1, lac[..., 0])
    lac = np.where(on[..., None] | stray, lac, 0)
    # TotalCoeff, in raster order of the 4x4 blocks
    count = np.where(on, (lac != 0).sum(-1), 0)
    raster = [((b >> 3) << 3) | (((b >> 1) & 1) << 2) |
              (((b >> 2) & 1) << 1) | (b & 1) for b in range(16)]
    nnz = np.zeros_like(count)
    nnz[..., raster] = count
    cac = np.where(rng.random((K, n, 8, 1)) < 0.5, 0,
                   _coeffs(rng, (K, n, 8, 16)))
    cdc = np.where(rng.random((K, n, 1)) < 1 / 3, 0, _coeffs(rng, (K, n, 8)))
    for o, v in ((la, lac), (ld, _coeffs(rng, (K, n, 16))), (ca, cac),
                 (cd, cdc), (nz, nnz)):
        rec[:, :, o:o + v[0, 0].size] = v.reshape(K, n, -1)
    pick = rng.random((K, n))
    rec[:, :, qp] = np.where(pick < 0.2, 0, np.where(
        pick < 0.4, 51, rng.integers(0, 52, (K, n))))
    rec[:, :, kind] = rng.choice(np.array([0, 1, 1, 1, 3, 4, 8]), (K, n))
    return rec, offs


def coded_fraction(rec, offs) -> float:
    """The fraction of the records' luma blocks whose TotalCoeff is above
    0 (``RESIDUAL_FIELDS`` at offs)."""
    nz = offs[6]
    return float((rec[:, :, nz:nz + 16] > 0).mean())


def mc_dec_inputs(gw: int, gh: int, S: int, seed: int, band=False,
                  coherent=False):
    """Seeded inputs of one ``mc_recon_fast`` call, numpy, in its order:
    the reference stacks (the GOP scan's uint8 ring of
    ``d_gop.ring_shapes``, or with ``band`` the sharded band step's int32
    stacks of the padded picture's own size), noise everywhere (so that a
    wrong clamp reads another value); per 4x4 block an MV (a third
    within 16 quarter pels, a third within the pad, a third up to 2,000
    quarter pels out; with ``coherent`` one MV an MB, within 64 quarter
    pels, for all its blocks), per 8x8 quadrant a slot in 0..S-1 and the
    weights [w, o, logWD] (w and o in -128..127, logWD 0..7; a quarter
    the identity), chroma each plane its own; residual planes mostly
    small, 2% up to 2^25; MBs inter with probability 0.8."""
    import numpy as np
    from hartallo_tpu_torch.decode.d_gop import _QUAD, ring_shapes
    rng = np.random.default_rng(seed)
    H, W, N = gh * 16, gw * 16, gh * gw * 16
    if band:
        shapes = ((S, 4, H + 64, W + 64), (S, H // 2 + 64, W // 2 + 64),
                  (S, H // 2 + 64, W // 2 + 64))
        dtype = np.int32
    else:
        shapes, dtype = ring_shapes(gw, gh, S), np.uint8
    stacks = [rng.integers(0, 256, s).astype(dtype) for s in shapes]
    reach = rng.choice(np.array([16, 4 * 40, 2000]), (N, 2))
    mv = rng.integers(-reach, reach + 1).astype(np.int32)
    if coherent:
        mv = np.repeat(rng.integers(-64, 65, (gh * gw, 2)), 16,
                       axis=0).astype(np.int32)

    def per_quad(a):                     # (gh, gw, 4, ...) -> (N, ...)
        return np.ascontiguousarray(
            a[:, :, _QUAD].reshape((N,) + a.shape[3:])).astype(np.int32)

    def weights(shape):
        wp = np.stack([rng.integers(-128, 128, shape),
                       rng.integers(-128, 128, shape),
                       rng.integers(0, 8, shape)], -1)
        ident = rng.random(shape) < 0.25
        wp[ident] = (1, 0, 0)
        return wp
    slot = per_quad(rng.integers(0, S, (gh, gw, 4)))
    wp_l = per_quad(weights((gh, gw, 4)))
    wp_c = per_quad(weights((gh, gw, 4, 2)))

    def residual(shape):
        r = rng.integers(-300, 301, shape)
        big = rng.random(shape) < 0.02
        return np.where(big, rng.integers(-(1 << 25), 1 << 25, shape),
                        r).astype(np.int32)
    return (*stacks, mv, slot, wp_l, wp_c, residual((H, W)),
            residual((2, H // 2, W // 2)), rng.random((gh, gw)) < 0.8)


def ring_write_inputs(gw: int, gh: int, S: int, seed: int):
    """Seeded inputs of one ``ring_write_fast`` call, numpy: the deblocked
    PAD-padded planes (Y, U, V) int32 0..255 (noise in the pad too, which
    the function must not read; pass their interiors), the uint8 rings of
    ``d_gop.ring_shapes`` with noise, the slot to write and a noisy
    output row."""
    import numpy as np
    from hartallo_tpu_torch.decode.d_gop import ring_shapes
    rng = np.random.default_rng(seed)
    H, W = gh * 16, gw * 16
    planes = [rng.integers(0, 256, s).astype(np.int32) for s in (
        (H + 64, W + 64), (H // 2 + 64, W // 2 + 64),
        (H // 2 + 64, W // 2 + 64))]
    rings = [rng.integers(0, 256, s).astype(np.uint8)
             for s in ring_shapes(gw, gh, S)]
    out = rng.integers(0, 256, (H * 3 // 2, W)).astype(np.uint8)
    return planes, rings, int(rng.integers(0, S)), out


def deblock_phase(torch, card):
    """The frame deblock kernel against its plain twin at DEBLOCK_GRIDS
    (the twin timed on its check run); returns (max_abs_err, and at 720p,
    the geometry the encode path deblocks most: the wrapper's and the
    twin's ms per frame and the bound)."""
    from hartallo_tpu_torch.ops import deblock_fast as D
    from hartallo_tpu_torch.ops.deblock import edge_params
    max_err, at720 = 0, None
    for name, gw, gh, flags in DEBLOCK_GRIDS:
        planes, rest = deblock_inputs(gw, gh, SEED + gw, flags)
        tp = tuple(torch.tensor(p, device="cuda") for p in planes)
        ta = tuple(torch.tensor(a, device="cuda") for a in rest)
        got = D.deblock_frame_fast(tp, *ta, gw=gw, gh=gh)
        plain = []
        plain_ms = event_ms(torch, lambda: plain.append(
            D.deblock_frame_fast_plain(tp, *ta, gw=gw, gh=gh)), 1,
            warm=False)
        want = plain[0]
        err = max(int((g - w).abs().max()) for g, w in zip(got, want))
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        print(f"deblock kernel phase {name} ({gw}x{gh} MBs): "
              f"byte-equal={same} max_abs_err={err}", flush=True)
        if not same:
            raise SystemExit(f"deblock kernel != plain at {name}")
        max_err = max(max_err, err)
        ms = event_ms(torch, lambda: D.deblock_frame_fast(
            tp, *ta, gw=gw, gh=gh), 20)
        aux = edge_params(*ta).to(torch.int16).contiguous()
        launch_ms = event_ms(torch, lambda: D._launch(aux, tp, gw=gw,
                                                      gh=gh), 20)
        bound_ms, bound_by = deblock_bound(planes, rest)
        if name == "720p":
            at720 = (ms, plain_ms, bound_ms, bound_by)
        print(f"[{card}] deblock {name}: kernel {ms * 1e3:.1f} us/frame "
              f"(launch alone, parameters gathered before: "
              f"{launch_ms * 1e3:.1f}), plain torch {plain_ms * 1e3:.1f} "
              f"us/frame, bound {bound_ms * 1e3:.3f} us ({bound_by})",
              flush=True)
    return max_err, at720


def intra_inputs(W: int, H: int, seed: int, masked=False, slices=1,
                 flat=False, qp=30, cqo=0, lam_qp=30):
    """numpy inputs of ``intra_encode_frame`` at the MB grid of W x H: the
    first ``bench.make_clip`` frame edge-padded as the encoder pads it (a
    flat grey picture with ``flat``); qp ``qp`` everywhere, or per MB over
    0..51 where ``qp`` is None; the availability maps of ``slices`` row
    slices; with ``masked``, about 10% of the MBs in the mask and seeded
    base planes.  Returns (gw, gh, the positional arguments, the
    keyword arguments)."""
    import numpy as np
    from bench import make_clip
    from hartallo_tpu_torch.decode.intra_recon import (availability_masks,
                                                       availability_tl,
                                                       availability_tr)
    from hartallo_tpu_torch.encode.e_device import pack_src
    from hartallo_tpu_torch.encode.encoder import _lambda
    gw, gh = -(-W // 16), -(-H // 16)
    rng = np.random.default_rng(seed)
    src = pack_src(make_clip(W, H, 1)[0], W, H, gw, gh)
    y = src[:gh * 16].astype(np.int32)
    uv = src[gh * 16:].reshape(gh * 8, 2, gw * 8).astype(np.int32)
    planes = [y, uv[:, 0], uv[:, 1]]
    if flat:
        planes = [np.full_like(p, 128) for p in planes]
    planes = [np.pad(p, 32, mode="edge") for p in planes]
    qpm = (rng.integers(0, 52, (gh, gw)) if qp is None else
           np.full((gh, gw), qp)).astype(np.int32)
    sid = (np.arange(gh) * slices // gh)[:, None].repeat(gw, 1)
    inter = np.zeros((gh, gw), bool)
    al, at = availability_masks(sid, False, inter)
    kw = {}
    if masked:
        kw = {"base_planes": tuple(rng.integers(0, 256, p.shape)
                                   .astype(np.int32) for p in planes),
              "mb_mask": rng.random((gh, gw)) < 0.1}
    return gw, gh, (*planes, qpm, cqo, al, at, _lambda(lam_qp),
                    availability_tr(sid, False, inter),
                    availability_tl(sid, False, inter)), kw


def intra_dec_inputs(gw: int, gh: int, seed: int, kinds=(0, 0, 0, 1),
                     rows=None, constrained=False, tr_false_row=None,
                     none_tr=False, diagonal=False, modes=(9, 4, 4),
                     layout=None):
    """numpy inputs of ``intra_reconstruct`` at gw x gh MBs: (the three
    PAD-padded int32 planes, then res_y, res_c, kind, i16_mode, i4_modes,
    chroma_mode, avail_left, avail_top, avail_tr).  The planes' interiors
    are seeded samples (the inter pixels; with ``diagonal`` noise constant
    along each anti-diagonal x + y, which the diagonal down-left and
    vertical left Intra4x4 modes predict from the top-right samples), their
    pads zero; residuals in -60..60, so that sums clip; each MB's kind
    drawn from ``kinds`` (0 I4x4, 1 I16, others left alone); modes drawn
    from 0 .. ``modes`` - 1 (Intra4x4, Intra16x16, chroma: larger values
    are clamped by the twin); the availability of slices of ``rows`` MB
    rows (one slice when None), constrained intra prediction (inter
    neighbours unavailable) with ``constrained``, the above-right flags of
    MB row ``tr_false_row`` all false, or None for avail_tr with
    ``none_tr``.  ``layout`` places the MBs drawn from ``kinds`` and makes
    every other MB inter (kind 3): "staircase", where (mx + my) % 3 == 0,
    so that each lies under the above-right one and beside inter MBs,
    with every Intra4x4 MB's block 5 in mode 3 or 7 (the modes that read
    the above-right MB); "columns", the even columns, so that every one
    right of column 0 has an inter MB on its left."""
    import numpy as np
    from hartallo_tpu_torch.decode.intra_recon import (availability_masks,
                                                       availability_tr)
    rng = np.random.default_rng(seed)
    H, W = gh * 16, gw * 16
    planes = []
    for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2)):
        if diagonal:
            noise = rng.integers(0, 256, h + w)
            inner = noise[np.arange(h)[:, None] + np.arange(w)[None, :]]
        else:
            inner = rng.integers(0, 256, (h, w))
        planes.append(np.pad(inner, 32).astype(np.int32))
    kind = rng.choice(np.asarray(kinds), (gh, gw)).astype(np.int32)
    my, mx = np.mgrid[:gh, :gw]
    if layout is not None:
        keep = {"staircase": (mx + my) % 3 == 0, "columns": mx % 2 == 0}
        kind = np.where(keep[layout], kind, 3).astype(np.int32)
    inter = (kind >= 3) & (kind != 8)
    sid = (np.arange(gh) // (rows or gh))[:, None].repeat(gw, 1)
    al, at = availability_masks(sid, constrained, inter)
    atr = availability_tr(sid, constrained, inter)
    if tr_false_row is not None:
        atr[tr_false_row] = False
    res_y = rng.integers(-60, 61, (gh, gw, 16, 16)).astype(np.int32)
    res_c = rng.integers(-60, 61, (gh, gw, 2, 8, 8)).astype(np.int32)
    i16m = rng.integers(0, modes[1], (gh, gw)).astype(np.int32)
    i4m = rng.integers(0, modes[0], (gh, gw, 16)).astype(np.int32)
    if layout == "staircase":
        i4m[..., 5] = rng.choice(np.asarray([3, 7]), (gh, gw))
    return (*planes, res_y, res_c, kind, i16m, i4m,
            rng.integers(0, modes[2], (gh, gw)).astype(np.int32), al, at,
            None if none_tr else atr)


def intra_pairs(got, want):
    """(name, got, want) for each of the eleven outputs of two
    ``intra_encode_frame`` results."""
    return [*zip(("recY", "recU", "recV"), got[:3], want[:3]),
            *((k, got[3][k], want[3][k]) for k in want[3])]


def intra_diff(got, want, gw: int, gh: int):
    """(max_abs_err, the first MB (my, mx) where any output differs, or
    None) of two ``intra_encode_frame`` results."""
    err, first = 0, None
    for name, g, w in intra_pairs(got, want):
        bad = g != w
        if not bool(bad.any()):
            continue
        err = max(err, int((g.long() - w.long()).abs().max()))
        if name.startswith("rec"):        # a recon sample -> its MB
            size = 16 if name == "recY" else 8
            y, x = (int(v) for v in bad.nonzero()[0])
            mb = (min(max(y - 32, 0) // size, gh - 1),
                  min(max(x - 32, 0) // size, gw - 1))
        else:
            mb = tuple(int(v) for v in bad.nonzero()[0][:2])
        first = mb if first is None else min(first, mb)
    return err, first


def intra_phase(torch, card):
    """The intra encode kernel against its plain twin on INTRA_CASES,
    tolerance 0 on all eleven outputs (the twin timed on its check run);
    then the kernel's time per picture at INTRA_TIMED, with its wrapper
    (CUDA events) and alone (the profiler's device time), beside its
    bound and its chain floor: the gw + 2 gh - 2 MBs of the critical path
    times the one-MB picture's kernel time.  Returns (max_abs_err, and at
    720p: the kernel's and the twin's ms per picture and the bound)."""
    import numpy as np
    from hartallo_tpu_torch.encode import intra_encode_fast as IF

    def cuda(a):
        if isinstance(a, tuple):
            return tuple(map(cuda, a))
        return torch.tensor(a, device="cuda") \
            if isinstance(a, np.ndarray) else a
    max_err, plain_ms, timed = 0, {}, {}
    for k, (label, W, H, opts) in enumerate(INTRA_CASES):
        gw, gh, args, kw = intra_inputs(W, H, SEED + k, **opts)
        ta, tkw = cuda(args), {n: cuda(v) for n, v in kw.items()}
        got = IF.intra_encode_frame_fast(*ta, **tkw, gw=gw, gh=gh)
        plain = []
        ms = event_ms(torch, lambda: plain.append(IF.intra_encode_frame(
            *ta, **tkw, gw=gw, gh=gh)), 1, warm=False)
        err, first = intra_diff(got, plain[0], gw, gh)
        print(f"intra kernel phase {label} ({gw}x{gh} MBs, grid of {gh} "
              f"blocks of {IF.THREADS} threads): max_abs_err={err} first "
              f"differing MB (my, mx)={first}", flush=True)
        if first is not None:
            raise SystemExit(f"intra kernel != plain at {label}")
        max_err = max(max_err, err)
        if label in ("CIF", "720p"):
            plain_ms[label] = ms
        if label in INTRA_TIMED:
            def call():
                IF.intra_encode_frame_fast(*ta, **tkw, gw=gw, gh=gh)
            timed[label] = (event_ms(torch, call, 10),
                            kernel_us(torch, call, 10, "intra_encode"), gw,
                            gh)
    mb_us = timed["one MB"][1]
    for label, (ms, dev_us, gw, gh) in timed.items():
        bound_ms, bound_by = intra_bound(gw, gh, False)
        twin = f", plain torch {plain_ms[label] * 1e3:.1f} us" \
            if label in plain_ms else ""
        chain = gw + 2 * gh - 2
        dev = "not measured" if dev_us is None else f"{dev_us:.1f} us"
        floor = "not measured" if mb_us is None else \
            f"{chain} MBs x {mb_us:.1f} us = {chain * mb_us:.1f} us"
        print(f"[{card}] intra kernel {label}: {ms * 1e3:.1f} us/picture "
              f"with the wrapper, kernel alone {dev}, chain floor {floor}"
              f"{twin}, bound {bound_ms * 1e3:.3f} us ({bound_by})",
              flush=True)
    ms, _, gw, gh = timed["720p"]
    return max_err, (ms, plain_ms["720p"], *intra_bound(gw, gh, False))


# (label, gw, gh, intra_dec_inputs options): the decoder's intra wavefront
# against its twin; all-intra pictures at the timed sizes, and a 1080p
# picture with one intra MB in 50 (the scan and shard routes' common case)
INTRA_DEC_CASES = (
    ("one MB", 1, 1, {}),
    ("QCIF mixed with inter MBs", 11, 9, {"kinds": (0, 1, 3, 4, 8)}),
    ("CIF", 22, 18, {}),
    ("CIF constrained, 3 slices, tr false on row 7", 22, 18,
     {"kinds": (0, 1, 3), "rows": 6, "constrained": True,
      "tr_false_row": 7}),
    ("CIF, intra under intra above-right", 22, 18,
     {"kinds": (0,), "layout": "staircase"}),
    ("CIF all inter", 22, 18, {"kinds": (3, 4, 5)}),
    ("720p", 80, 45, {}),
    ("1080p", 120, 68, {}),
    ("band 120x34", 120, 34, {}),
    ("1080p, one intra MB in 50", 120, 68, {"kinds": (0,) + (3,) * 49}),
)
DEC_TIMED = ("CIF", "720p", "1080p", "band 120x34",
             "1080p, one intra MB in 50")
# all-intra pictures timed for the wavefront's chain model: one MB, a row
# of 120 MBs (gives the in-row step s) and a column of 68 (the row-to-row
# hand-off h)
DEC_UNITS = (("one MB", 1, 1), ("120x1", 120, 1), ("1x68", 1, 68))


def intra_dec_bound(gw: int, gh: int, n_intra=None):
    """Bound of one ``intra_reconstruct_fast`` call on a picture with
    ``n_intra`` intra MBs (all when None): bytes, the function's new
    PAD-padded int32 planes written, its input planes read but the intra
    MBs' samples (each is predicted anew), the intra MBs' int32 residuals
    and modes (406 words an MB) and the other MBs' kinds read;
    operations, 8 a predicted sample (three taps, the rounding, the
    shift, the residual, the clip)."""
    n = gw * gh if n_intra is None else n_intra
    planes = 4 * ((gh * 16 + 64) * (gw * 16 + 64) +
                  2 * (gh * 8 + 64) * (gw * 8 + 64))
    read = planes - 4 * 384 * n
    return bound(planes + read + n * 406 * 4 + (gw * gh - n) * 4,
                 8 * 384 * n)


def intra_dec_model(gw: int, gh: int, s_us: float, h_us: float) -> float:
    """The wavefront's chain model in µs (launch excluded): gw in-row
    steps s, and for each row below the first two steps and a hand-off
    h."""
    return gw * s_us + (gh - 1) * (2 * s_us + h_us)


def params_dec_bound(gw: int, gh: int, K: int = 1):
    """Bound of one ``deblock_params_dec_fast`` call: bytes, the 59 int16
    words of an MB's record read once and its 62 int16 words written;
    operations, about 40 a 4x4 block (its two bS and its share of the six
    sets)."""
    n = K * gw * gh
    return bound(n * (59 * 2 + 62 * 2), 40 * 16 * n)


def params_dec_bound_int32(gw: int, gh: int, K: int = 1):
    """``params_dec_bound`` as counted before the records reached the card
    as int16: the 59 words read as int32."""
    n = K * gw * gh
    return bound(n * (59 * 4 + 62 * 2), 40 * 16 * n)


def residual_dec_bound(rec, offs):
    """Bound of one ``residual_planes_fast`` call on the int16 records rec
    (K, gh*gw, words) (numpy or a tensor, ``RESIDUAL_FIELDS`` at offs):
    bytes, what these inputs need read once (each MB's qp, kind, nnz and
    chroma levels and DC; the luma DC of an I16 MB; the 16 levels of each
    luma block whose TotalCoeff is above 0) and its 384 int32 samples
    written; operations, about 12 a sample (the dequant's multiply,
    rounding and shift, the inverse transform's two stages, the DC's
    share)."""
    import numpy as np
    r = np.asarray(rec.cpu() if hasattr(rec, "cpu") else rec)
    n = r.shape[0] * r.shape[1]
    kind, nz = offs[5], offs[6]
    coded = int((r[:, :, nz:nz + 16] > 0).sum())
    i16 = int((r[:, :, kind] == 1).sum())
    read = 2 * (n * (1 + 1 + 16 + 128 + 8) + 16 * i16 + 16 * coded)
    return bound(read + n * 384 * 4, 12 * 384 * n)


def residual_dec_bound_int32(gw: int, gh: int, K: int = 1):
    """``residual_dec_bound`` as counted before the records reached the
    card as int16 and the levels of uncoded blocks were skipped: the 410
    words of an MB's record it reads (coefficients, qp and kind) as
    int32."""
    n = K * gw * gh
    return bound(n * (410 * 4 + 384 * 4), 12 * 384 * n)


def mc_dec_bound(gw: int, gh: int, n_inter: int, elem: int):
    """Bound of one ``mc_recon_fast`` call with ``n_inter`` inter MBs and
    reference samples of ``elem`` bytes: bytes, the three padded int32
    planes written, and for each inter MB its residual (384 int32), its
    16 blocks' MV, slot and weights (12 words each) and at least one
    reference sample per predicted sample read, and the inter mask;
    operations, about 10 a predicted sample (taps, average or bilinear
    sum, weight, residual, clip)."""
    H, W = gh * 16, gw * 16
    out = 4 * ((H + 64) * (W + 64) + 2 * (H // 2 + 64) * (W // 2 + 64))
    return bound(out + n_inter * (384 * 4 + 16 * 12 * 4 + 384 * elem) +
                 gw * gh, 10 * 384 * n_inter)


def ring_write_bound(gw: int, gh: int, hr: int, wr: int, hcr: int,
                     wcr: int):
    """Bound of one ``ring_write_fast`` call into a ring of (4, hr, wr) and
    (hcr, wcr) byte slots: bytes, the three deblocked int32 interiors
    read, the slot's four luma planes and two chroma planes and the
    (H*3/2, W) output row written; operations, the half-pel filters' 36
    a padded luma sample (as ``gop_bound``)."""
    H, W = gh * 16, gw * 16
    return bound(4 * H * W * 3 // 2 + 4 * hr * wr + 2 * hcr * wcr +
                 H * W * 3 // 2, 36 * (H + 64) * (W + 64))


# the GOP scan kernels' cases: (label, gw, gh, the band's int32 stacks);
# timed per picture at all but QCIF
MC_DEC_CASES = (("QCIF", 11, 9, False), ("CIF", 22, 18, False),
                ("720p", 80, 45, False), ("1080p", 120, 68, False),
                ("band 120x34", 120, 34, True))
MC_DEC_TIMED = ("CIF", "720p", "1080p", "band 120x34")


def scan_kernels(torch, label, gw, gh, rec, offs, mc, rw, timed=True,
                 residual_bound=None):
    """The GOP scan's three kernels on one picture's inputs, each against
    its plain twin (tolerance 0; SystemExit where they differ) and, with
    ``timed``, timed: rec (1, gh*gw, words) int16 records with the
    offsets offs of ``mc_decode_fast.RESIDUAL_FIELDS`` (chroma QP offset
    0); mc the arguments of ``mc_recon_fast``; rw those of
    ``ring_write_fast`` (the deblocked interiors, the rings, the slot and
    the output row: the kernel writes into them, the twin into copies);
    ``residual_bound`` the residual's bound where the caller counts it
    (else ``residual_dec_bound`` of rec).
    Returns {key: (max_abs_err, ms with the wrapper (CUDA events), µs
    alone (``kernel_us``), the wrapper's host µs (``host_us``), the
    twin's ms on its check run, (bound ms, bound by))} for MC_KERNELS;
    the three times None without ``timed``."""
    from hartallo_tpu_torch.decode import mc_decode_fast as M
    hr, wr = rw[3].shape[2:]
    hcr, wcr = rw[4].shape[1:]
    twin_rw = (*rw[:3], *(r.clone() for r in rw[3:6]), rw[6], rw[7].clone())
    calls = {
        "residual_dec": (M.residual_planes_fast, M.residual_planes_plain,
                         (rec, offs, 0), (rec, offs, 0),
                         residual_bound or residual_dec_bound(rec, offs)),
        "mc_dec": (M.mc_recon_fast, M.mc_recon_plain, mc, mc,
                   mc_dec_bound(gw, gh, int(mc[-1].sum()),
                                mc[0].element_size())),
        "ring_write_dec": (M.ring_write_fast, M.ring_write_plain, rw, twin_rw,
                           ring_write_bound(gw, gh, hr, wr, hcr, wcr))}

    def ring_rows(a):                # the ring write's outputs: rings, row
        return (*a[3:6], a[7])
    return {key: kernel_alone(torch, label, key, fast, twin, a, ta, bnd, gw,
                              gh, timed,
                              ring_rows if key == "ring_write_dec" else None)
            for key, (fast, twin, a, ta, bnd) in calls.items()}


def kernel_alone(torch, label, key, fast, twin, a, ta, bound, gw, gh,
                 timed=True, outputs=None):
    """One of DEC_KERNELS' wrappers, ``fast(*a, gw=, gh=)``, against its
    plain twin ``twin(*ta, gw=, gh=)`` (tolerance 0; SystemExit where
    they differ; ``outputs(args)`` the outputs where the call writes into
    its arguments) and, with ``timed``, timed.  Returns (max_abs_err, ms
    with the wrapper (CUDA events), µs alone (``kernel_us``), the
    wrapper's host µs (``host_us``), the twin's ms on its check run,
    bound); the three times None without ``timed``."""
    def run(f, args):
        r = f(*args, gw=gw, gh=gh)
        return r if outputs is None else outputs(args)
    got = run(fast, a)
    want = []
    plain_ms = event_ms(torch, lambda: want.append(run(twin, ta)), 1,
                        warm=False)
    err, same, _ = outputs_diff(torch, got, want[0])
    if not same:
        raise SystemExit(f"the {key} kernel != plain at {label}")

    def fn():
        fast(*a, gw=gw, gh=gh)
    return (err, *((event_ms(torch, fn, 20),
                    kernel_us(torch, fn, 20, DEC_KERNELS[key]),
                    host_us(fn, 20)) if timed else (None,) * 3),
            plain_ms, bound)


def upload_phase(torch, card):
    """The GOP scan batch's way to the card at 1080p: the int16 rows of
    ``1080p_8_wp``'s scan batch (its 7 P pictures, as the decoder parses
    them) in the page-locked buffer of a ``decode/staging.RowStaging``
    (one a batch, as the decoder takes them) and from there on the card
    through one asynchronous copy (``upload``), ended by a synchronize;
    the median of five after two warm-ups, host clock.  First
    ``pinned_reuse_check``.  Returns the upload's ms."""
    import statistics

    from hartallo_tpu_torch.decode.decoder import Decoder
    from hartallo_tpu_torch.decode.staging import RowStaging
    pinned_reuse_check(torch)
    dec = Decoder(device="cuda", batch_k=1 << 30)
    dec.enqueue_annexb(load_fixture("1080p_8_wp")[0], tolerant=False)
    rows = [j.packed for j in dec.layer.jobs if j.packed is not None]
    nbytes = sum(r.nbytes for r in rows)
    up_s = []
    for i in range(7):
        staging = RowStaging("cuda")
        for k, r in enumerate(rows):
            staging.row(k, r.shape)[...] = r
        host = staging.rows(0, len(rows))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = staging.upload(host)
        torch.cuda.synchronize()
        if i >= 2:
            up_s.append(time.perf_counter() - t0)
    if not (host.is_pinned() and got.dtype == torch.int16 and
            torch.equal(got.cpu(), host)):
        raise SystemExit("upload phase: the staged rows are not page-locked "
                         "or did not reach the card as they are")
    up = statistics.median(up_s)
    print(f"[{card}] 1080p_8_wp scan batch upload: {len(rows)} pictures, "
          f"{nbytes / 1e6:.1f} MB of int16 rows from the page-locked buffer "
          f"in {up * 1e3:.3f} ms ({nbytes / up / 1e9:.1f} GB/s), "
          f"{up * 1e3 / len(rows):.3f} ms a picture", flush=True)
    return up * 1e3


def pinned_reuse_check(torch):
    """What ``decode/staging.py`` rests on: PyTorch's caching host
    allocator does not hand out page-locked memory again while a
    ``non_blocking`` copy from it (here from a view of it, as the decoder
    copies a run of a batch's rows) is still queued behind a busy stream;
    once the copy has ended, the memory comes back.  SystemExit where the
    allocator hands it out early, the copy reads rows written after it
    was queued, or the memory does not come back."""
    shape = (7, 8160, 524)
    buf = torch.full(shape, 3, dtype=torch.int16, pin_memory=True)
    ptr = buf.data_ptr()
    torch.cuda._sleep(200_000_000)          # about 0.1 s of the stream
    got = buf[1:].to("cuda", non_blocking=True)
    del buf
    early = torch.empty(shape, dtype=torch.int16, pin_memory=True)
    early.fill_(5)
    torch.cuda.synchronize()
    if early.data_ptr() == ptr or not bool((got == 3).all()):
        raise SystemExit("pinned reuse check: the page-locked buffer was "
                         "handed out again while its copy was queued")
    del early
    again = [torch.empty(shape, dtype=torch.int16, pin_memory=True)
             for _ in range(2)]
    if ptr not in [a.data_ptr() for a in again]:
        raise SystemExit("pinned reuse check: the page-locked buffer did "
                         "not come back once its copy had ended")
    print("pinned reuse check: a page-locked buffer is held while its "
          "copy is queued and handed out again after it", flush=True)


def mc_dec_phase(torch, card):
    """The GOP scan's residual, MC and ring write kernels against their
    plain twins (tolerance 0) on seeded inputs at MC_DEC_CASES: the
    residual on two pictures a launch at chroma QP offsets -12, 0 and 12
    on each of RESIDUAL_SETS' int16 records (``residual_rec_inputs``: qp
    0..51, I16 MBs, int16-extreme coefficients; no, 15% and all luma
    blocks coded, each MB its own, stray levels; their coded fractions
    printed), the MC on three slots (``mc_dec_inputs``: per-4x4 MVs
    up to 2,000 quarter pels out, and coherent motion, one MV an MB;
    weights with logWD 0..7; the scan's uint8 ring, and at the band the
    int32 stacks), the ring write (``ring_write_inputs``); then
    ``scan_kernels`` on one picture (the mixed set): each kernel checked
    again, and at MC_DEC_TIMED per picture with its wrapper (CUDA events)
    and alone (``kernel_us``), the twin (timed on its check run) and the bound.
    Returns (max_abs_err, and at 1080p: the wrapper's and the twin's ms
    and the bound) for each kernel."""
    from hartallo_tpu_torch.decode import mc_decode_fast as M

    def cuda(a):
        return torch.tensor(a, device="cuda")

    def checked(key, label, fast, plain, args):
        e, same, _ = outputs_diff(torch, fast(*args), plain(*args))
        if not same:
            raise SystemExit(f"the {key} kernel != plain at {label}")
        errs[key] = max(errs[key], e)
    errs = dict.fromkeys(MC_KERNELS, 0)
    results = {}
    for k, (label, gw, gh, band) in enumerate(MC_DEC_CASES):
        fractions = []
        for j, (set_label, coded, stray) in reversed(
                list(enumerate(RESIDUAL_SETS))):
            rec, offs = residual_rec_inputs(gw, gh, 2, SEED + k + 10 * j,
                                            coded=coded, stray=stray)
            trec = cuda(rec)
            for cqo in (-12, 0, 12):
                checked("residual_dec", f"{label}, {set_label}, offset {cqo}",
                        lambda r, c: M.residual_planes_fast(r, offs, c,
                                                            gw=gw, gh=gh),
                        lambda r, c: M.residual_planes_plain(r, offs, c,
                                                             gw=gw, gh=gh),
                        (trec, cqo))
            fractions.append(f"{set_label} {coded_fraction(rec, offs):.3f}")
        # rec and trec are now the mixed set's, timed below
        print(f"residual kernel {label}: == plain on the int16 record sets "
              f"(their fraction of coded luma blocks): "
              f"{', '.join(reversed(fractions))}", flush=True)
        checked("mc_dec", f"{label}, coherent motion",
                lambda *a: M.mc_recon_fast(*a, gw=gw, gh=gh),
                lambda *a: M.mc_recon_plain(*a, gw=gw, gh=gh),
                [cuda(a) for a in mc_dec_inputs(gw, gh, 3, SEED + k,
                                                band=band, coherent=True)])
        case = [cuda(a) for a in mc_dec_inputs(gw, gh, 3, SEED + k,
                                               band=band)]
        planes, rings, ws, out = ring_write_inputs(gw, gh, 3, SEED + k)
        rw = (*(cuda(p)[32:-32, 32:-32] for p in planes),
              *(cuda(r) for r in rings), ws, cuda(out))
        timed = label in MC_DEC_TIMED
        got = scan_kernels(torch, label, gw, gh, trec[:1].contiguous(), offs,
                           case, rw, timed)
        for key, (e, *_) in got.items():
            errs[key] = max(errs[key], e)
        print(f"GOP scan kernels phase {label} ({gw}x{gh} MBs): residual, "
              f"MC ({'int32' if band else 'uint8'} stacks; seeded and "
              f"coherent motion) and ring write == plain", flush=True)
        for key, (_, ms, dev_us, _, plain_ms, (b_ms, b_by)) in (
                got.items() if timed else ()):
            dev = "not measured" if dev_us is None else f"{dev_us:.2f} us"
            old = ""
            if key == "residual_dec":
                old = f"; counted as int32 words, all levels read: " \
                    f"{residual_dec_bound_int32(gw, gh)[0] * 1e3:.3f} us"
            print(f"[{card}] GOP scan kernel {DEC_KERNELS[key]} {label}: "
                  f"{ms * 1e3:.1f} us/picture with the wrapper, kernel "
                  f"alone {dev}, plain torch {plain_ms * 1e3:.1f} us, bound "
                  f"{b_ms * 1e3:.3f} us ({b_by}{old})", flush=True)
            if label == "1080p":
                results[key] = (ms, plain_ms, b_ms, b_by)
    return errs, results


def dec_kernels_phase(torch, card):
    """The decoder's intra wavefront and deblock parameter kernels
    against their plain twins (tolerance 0): the wavefront on
    INTRA_DEC_CASES, the parameters on seeded records of 1 and 5 pictures
    at the same grids and in the GOP scan's dense buffer (the twins timed
    on their check runs); then both kernels alone per picture at
    DEC_TIMED (the profiler's device time) and with their wrappers (CUDA
    events), beside their bounds, and the wavefront's chain model
    (``intra_dec_model``) at the all-intra sizes: the in-row step s is
    the 120x1 picture's time less the launch floor (``launch_floor_us``)
    over 120, the hand-off h the 1x68 picture's so over 68, less s.
    Returns (max_abs_err, and at 720p: the wrapper's and the twin's ms
    and the bound) for each kernel."""
    import numpy as np
    from hartallo_tpu_torch.decode import intra_recon_fast as IDF
    from hartallo_tpu_torch.decode.intra_recon import intra_reconstruct
    from hartallo_tpu_torch.ops import deblock_fast as D

    def cuda(a):
        return None if a is None else torch.tensor(a, device="cuda")
    errs = {"intra_dec": 0, "deblock_params_dec": 0}
    plain_ms, timed, n_intra = {}, {}, {}
    for k, (label, gw, gh, opts) in enumerate(INTRA_DEC_CASES):
        args = [cuda(a) for a in intra_dec_inputs(gw, gh, SEED + k, **opts)]
        got = IDF.intra_reconstruct_fast(tuple(args[:3]), *args[3:], gw=gw,
                                         gh=gh)
        plain = []
        ms = event_ms(torch, lambda: plain.append(intra_reconstruct(
            tuple(args[:3]), *args[3:], gw=gw, gh=gh)), 1, warm=False)
        err = max(abs_err(g, w) for g, w in zip(got, plain[0]))
        same = all(torch.equal(g, w) for g, w in zip(got, plain[0]))
        rec, offs = deblock_rec_inputs(gw, gh, 1, SEED + k)
        trec = cuda(rec)
        aux = D.deblock_params_dec_fast(trec, offs, k % 5 - 2, gw=gw, gh=gh)
        pplain = []
        pms = event_ms(torch, lambda: pplain.append(
            D.deblock_params_dec_plain(trec, offs, k % 5 - 2, gw=gw,
                                       gh=gh)), 1, warm=False)
        perr = abs_err(aux, pplain[0])
        psame = torch.equal(aux, pplain[0])
        print(f"decode kernels phase {label} ({gw}x{gh} MBs): intra "
              f"wavefront == plain {same} max_abs_err={err}; deblock "
              f"parameters == plain {psame} max_abs_err={perr}", flush=True)
        if not (same and psame):
            raise SystemExit(f"a decode kernel != plain at {label}")
        errs["intra_dec"] = max(errs["intra_dec"], err)
        errs["deblock_params_dec"] = max(errs["deblock_params_dec"], perr)
        if label in DEC_TIMED:
            plain_ms[label] = (ms, pms)
    for label, (gw, gh, K, wide) in (("QCIF, 5 pictures", (11, 9, 5, False)),
                                     ("CIF, dense buffer", (22, 18, 2,
                                                             True))):
        rec, offs = deblock_rec_inputs(gw, gh, K, SEED, wide=wide,
                                       edge_flags=True)
        trec = cuda(rec)
        same = torch.equal(
            D.deblock_params_dec_fast(trec, offs, 3, gw=gw, gh=gh),
            D.deblock_params_dec_plain(trec, offs, 3, gw=gw, gh=gh))
        print(f"decode kernels phase {label}: deblock parameters == plain "
              f"{same}", flush=True)
        if not same:
            raise SystemExit(f"the deblock parameter kernel != plain at "
                             f"{label}")
    # timed: the model's unit pictures, then DEC_TIMED (all-intra pictures
    # with an Intra16x16 MB in four, and the sparse picture)
    cases = {label: (gw, gh, opts) for label, gw, gh, opts in
             INTRA_DEC_CASES if label in DEC_TIMED}
    for label, gw, gh, opts in (*((*u, {}) for u in DEC_UNITS),
                                *((k, *v) for k, v in cases.items())):
        inputs = intra_dec_inputs(gw, gh, SEED, **opts)
        n_intra[label] = int(np.isin(inputs[5], (0, 1)).sum())
        args = [cuda(a) for a in inputs]
        trec = cuda(deblock_rec_inputs(gw, gh, 1, SEED)[0])
        offs = deblock_rec_inputs(1, 1, 1, 0)[1]

        def intra():
            IDF.intra_reconstruct_fast(tuple(args[:3]), *args[3:], gw=gw,
                                       gh=gh)

        def params():
            D.deblock_params_dec_fast(trec, offs, 0, gw=gw, gh=gh)
        timed[label] = (event_ms(torch, intra, 10),
                        kernel_us(torch, intra, 10, "k_intra_decode"),
                        event_ms(torch, params, 20),
                        kernel_us(torch, params, 20, "k_deblock_params_dec"),
                        gw, gh)
    floor_us = launch_floor_us(torch)
    units = [timed[u[0]][1] for u in DEC_UNITS]
    s_us = h_us = None
    if None not in (floor_us, *units):
        s_us = (units[1] - floor_us) / 120
        h_us = (units[2] - floor_us) / 68 - s_us
    print(f"[{card}] decode kernels phase: intra wavefront alone: one MB "
          f"{units[0]} us, 120x1 {units[1]} us, 1x68 {units[2]} us; launch "
          f"floor {floor_us} us; in-row step s = {s_us} us, hand-off h = "
          f"{h_us} us", flush=True)
    for label in DEC_TIMED:
        ms, dev_us, pms, pdev_us, gw, gh = timed[label]
        dev = "not measured" if dev_us is None else f"{dev_us:.1f} us"
        pdev = "not measured" if pdev_us is None else f"{pdev_us:.2f} us"
        model = ""
        if n_intra[label] == gw * gh:
            model = ", chain model not measured" if s_us is None else \
                f", chain model {gw} s + {gh - 1} (2 s + h) = " \
                f"{intra_dec_model(gw, gh, s_us, h_us):.1f} us (+ the " \
                f"launch floor)"
        b_ms, b_by = intra_dec_bound(gw, gh, n_intra[label])
        pb_ms, pb_by = params_dec_bound(gw, gh)
        print(f"[{card}] intra decode kernel {label} ({n_intra[label]} "
              f"intra MBs): {ms * 1e3:.1f} us/picture with the wrapper, "
              f"kernel alone {dev}{model}, plain torch "
              f"{plain_ms[label][0] * 1e3:.1f} us, bound "
              f"{b_ms * 1e3:.3f} us ({b_by})", flush=True)
        print(f"[{card}] deblock parameter kernel (decoder) {label}: "
              f"{pms * 1e3:.1f} us/picture with the wrapper, kernel alone "
              f"{pdev}, plain torch {plain_ms[label][1] * 1e3:.1f} us, "
              f"bound {pb_ms * 1e3:.4f} us ({pb_by}; counted as int32 "
              f"words: {params_dec_bound_int32(gw, gh)[0] * 1e3:.4f} us)",
              flush=True)
    ms, _, pms, _, gw, gh = timed["720p"]
    return errs, {
        "intra_dec": (ms, plain_ms["720p"][0], *intra_dec_bound(gw, gh)),
        "deblock_params_dec": (pms, plain_ms["720p"][1],
                               *params_dec_bound(gw, gh))}


def me_inputs(W: int, H: int, seed: int, rng=12, lam_qp=30, band=False):
    """numpy inputs of the motion search at the MB grid of W x H: the
    second ``bench.make_clip`` frame's luma as the source and the first's
    as the reference, edge-padded as the encoder pads them (with
    ``band``, the second of four bands of MB rows, its reference
    halo-padded by ``parallel/shard._halo_pad`` as the sharded P step
    pads it); the f32 lambda of ``lam_qp``; seeded quarter-pel MVs in
    +-60 and partition maps over 0..3 for the refinement.  Returns (gw,
    gh, a dict of the inputs)."""
    import numpy as np
    import torch
    from bench import make_clip
    from hartallo_tpu_torch.encode.e_device import pack_src
    from hartallo_tpu_torch.encode.encoder import _lambda
    from hartallo_tpu_torch.parallel.shard import _halo_pad
    gw, gh = -(-W // 16), -(-H // 16)
    ref, src = (pack_src(f, W, H, gw, gh)[:gh * 16].astype(np.int32)
                for f in make_clip(W, H, 2))
    if band:
        gh //= SHARD_BANDS
        ref = _halo_pad([torch.from_numpy(b) for b in
                         np.split(ref, SHARD_BANDS)], 1).numpy()
        src = np.pad(np.split(src, SHARD_BANDS)[1], 32, mode="edge")
    else:
        ref, src = (np.pad(p, 32, mode="edge") for p in (ref, src))
    r = np.random.default_rng(seed)
    return gw, gh, {
        "src": src, "ref": ref, "lam": _lambda(lam_qp), "rng": rng,
        "mv": r.integers(-60, 61, (gh, gw, 16, 2)).astype(np.int32),
        "part": r.integers(0, 4, (gh, gw, 16)).astype(np.int32)}


def p_inputs(W: int, H: int, seed: int, qp=30, cqo=0, lam_qp=30,
             band=False, flat=False, intra=False, mv_max=None, flags=False):
    """numpy inputs of the P-picture body kernels at the MB grid of W x H:
    the second ``bench.make_clip`` frame's Y, U and V planes as the source
    and the first's as the reference, edge-padded as the encoder pads them
    (with ``band``, the second of four bands of MB rows, its reference
    planes halo-padded by ``parallel/shard._halo_pad``); with ``flat`` a
    grey source; with ``intra`` flat grey squares pasted into about half
    of the source's MBs, which the intra-in-P estimate takes; qp ``qp``
    everywhere, or per MB over 0..51 where it is None; the f32 lambda of
    ``lam_qp``; seeded quarter-pel MVs in +-``mv_max`` for the residual
    where it is set (else the path's, from the search); a seeded
    intra map and, with ``flags``, seeded MB edge flags (the picture's
    edges among them) for the deblock parameters.  Returns (gw, gh, a
    dict of the inputs)."""
    import numpy as np
    import torch
    from bench import make_clip
    from hartallo_tpu_torch.encode.e_device import pack_src
    from hartallo_tpu_torch.encode.encoder import _lambda
    from hartallo_tpu_torch.parallel.shard import _halo_pad
    gw, gh = -(-W // 16), -(-H // 16)
    r = np.random.default_rng(seed)
    frames = []
    for f in make_clip(W, H, 2):
        buf = pack_src(f, W, H, gw, gh)
        uv = buf[gh * 16:].reshape(gh * 8, 2, gw * 8).astype(np.int32)
        frames.append([buf[:gh * 16].astype(np.int32), uv[:, 0], uv[:, 1]])
    ref, src = frames
    if flat:
        src = [np.full_like(p, 128) for p in src]
    if intra:
        for my in range(gh):
            for mx in range(gw):
                if r.random() < 0.5:
                    v = int(r.integers(16, 240))
                    src[0][16 * my:16 * my + 16, 16 * mx:16 * mx + 16] = v
                    for c in src[1:]:
                        c[8 * my:8 * my + 8, 8 * mx:8 * mx + 8] = v
    if band:
        gh //= SHARD_BANDS
        ref = [_halo_pad([torch.from_numpy(b) for b in
                          np.split(p, SHARD_BANDS)], 1).numpy() for p in ref]
        src = [np.pad(np.split(p, SHARD_BANDS)[1], 32, mode="edge")
               for p in src]
    else:
        ref, src = ([np.pad(p, 32, mode="edge") for p in ps]
                    for ps in (ref, src))
    c = {"src": src, "ref": ref, "lam": _lambda(lam_qp), "rng": 12,
         "cqo": cqo,
         "qp": (r.integers(0, 52, (gh, gw)) if qp is None else
                np.full((gh, gw), qp)).astype(np.int32),
         "mv": None if mv_max is None else
         r.integers(-mv_max, mv_max + 1, (gh, gw, 16, 2)).astype(np.int32),
         "intra": r.random((gh, gw)) < 0.25, "fmb_v": None, "fmb_h": None}
    if flags:
        c["fmb_v"], c["fmb_h"] = (r.random((gh, gw)) < 0.8 for _ in "vh")
    return gw, gh, c


def me_path_maps(fs, lam):
    """The quarter-pel MVs and the partition map (numpy int32) that
    ``p_device.p_frame_device`` derives from the full search's eight
    outputs ``fs`` (numpy) and the f32 lambda: each MB's cheapest
    partitioning, its partitions' MVs on their 4x4 blocks.  The timing
    input of the refinement as the path gives it: a partition's blocks
    share their MV."""
    import numpy as np
    from hartallo_tpu_torch.encode.me import _PART_OF_BLK
    c16, v16, c168, v168, c816, v816, c88, v88 = fs
    lam = np.float32(lam)
    costs = np.stack([c16 + lam * np.float32(1),
                      (c168[..., 0] + c168[..., 1]) + lam * np.float32(3),
                      (c816[..., 0] + c816[..., 1]) + lam * np.float32(3),
                      (((c88[..., 0] + c88[..., 1]) + c88[..., 2]) +
                       c88[..., 3]) + lam * np.float32(9)])
    choice = costs.argmin(0)
    parts = np.stack([_PART_OF_BLK[k].reshape(16) for k in
                      ("16x16", "16x8", "8x16", "8x8")]).astype(np.int32)
    part = parts[choice]                                  # (gh, gw, 16)
    mv_part = np.zeros(choice.shape + (4, 2), np.int32)   # per partition
    for k, v in enumerate((v16[:, :, None], v168, v816, v88)):
        sel = choice == k
        mv_part[sel, :v.shape[2]] = v[sel]
    mv = np.take_along_axis(mv_part, part[..., None].astype(np.int64), 2)
    return 4 * mv, part


def me_diff(got, want):
    """(max_abs_err, equal) of two motion-search results (tuples of
    tensors); equal means the same shapes, types and values (an error of
    None where the shapes or types differ)."""
    if len(got) != len(want) or any(
            g.shape != w.shape or g.dtype != w.dtype
            for g, w in zip(got, want)):
        return None, False
    return (max(abs_err(g, w) for g, w in zip(got, want)),
            all(bool((g == w).all()) for g, w in zip(got, want)))


def abs_err(a, b):
    """The largest |a - b| of two tensors, an int where it is whole."""
    e = float((a.double() - b.double()).abs().max())
    return int(e) if e.is_integer() else e


def me_phase(torch, card):
    """The motion search kernels against their plain twins on ME_CASES,
    tolerance 0: the full search's eight outputs; then, on seeded MVs and
    partition maps, the one-round launches (the half-pel round, then the
    quarter-pel round on its result) against the twin's rounds, and the
    two-round launch against the twin's chain, MVs and costs (each twin
    timed on its check run), and the two-round launch on the MVs and
    partition map the path derives from this search (``me_path_maps``).
    Then at ME_TIMED each kernel's time per picture with its wrapper
    (CUDA events), alone (the profiler's device time) and the wrapper's
    host time per call, beside its bound; the refinement on the search's
    MVs (the path's input) and on the seeded ones.  Returns (max_abs_err
    of each kernel, and at 720p: each kernel's and twin's ms per picture
    and its bound)."""
    from hartallo_tpu_torch.encode import me as M
    from hartallo_tpu_torch.encode import me_fast as MF
    from hartallo_tpu_torch.ops.wide import halfpel_planes
    clock = sm_clock_hz()
    max_err = {"full_search": 0, "refine": 0}
    plain_ms, timed = {}, {}
    for k, (label, W, H, opts) in enumerate(ME_CASES):
        gw, gh, c = me_inputs(W, H, SEED + k, **opts)
        src, ref, mv, part = (torch.tensor(c[n], device="cuda")
                              for n in ("src", "ref", "mv", "part"))
        lam, rng = torch.tensor(c["lam"], device="cuda"), c["rng"]
        got = MF.full_search_int_fast(src, ref, lam, gw=gw, gh=gh, rng=rng)
        plain = []
        fs_plain = event_ms(torch, lambda: plain.append(M.full_search_int(
            src, ref, lam, gw=gw, gh=gh, rng=rng)), 1, warm=False)
        fs_err, fs_same = me_diff(got, plain[0])
        plain_fs = plain[0]
        hp = halfpel_planes(ref)
        rf_err, rf_same, rf_plain, want, one = 0, True, 0.0, (mv, None), mv
        for step in (2, 1):
            plain = []
            rf_plain += event_ms(torch, lambda: plain.append(
                M.refine_subpel(src, ref, want[0], part, lam, step, gw=gw,
                                gh=gh, nparts=4, hp=hp)), 1, warm=False)
            want = plain[0]
            got = MF.refine_subpel_fast(src, ref, one, part, lam, step,
                                        gw=gw, gh=gh, nparts=4, hp=hp)
            err, same = me_diff(got, want)
            rf_err, rf_same, one = max(rf_err, err), rf_same and same, got[0]
        got = MF.refine_subpel_rounds_fast(src, ref, mv, part, lam, (2, 1),
                                           gw=gw, gh=gh, nparts=4, hp=hp)
        err, two_same = me_diff(got, want)
        rf_err = max(rf_err, err)
        # the MVs and partition map the path derives from this search
        path_mv, path_part = (torch.tensor(a, device="cuda") for a in
                              me_path_maps([t.cpu().numpy() for t in
                                            plain_fs], c["lam"]))
        want = (path_mv, None)
        for step in (2, 1):
            want = M.refine_subpel(src, ref, want[0], path_part, lam, step,
                                   gw=gw, gh=gh, nparts=4, hp=hp)
        got = MF.refine_subpel_rounds_fast(src, ref, path_mv, path_part,
                                           lam, (2, 1), gw=gw, gh=gh,
                                           nparts=4, hp=hp)
        err, path_same = me_diff(got, want)
        rf_err = max(rf_err, err)
        print(f"ME kernel phase {label} ({gw}x{gh} MBs, range {rng}): full "
              f"search equal={fs_same} max_abs_err={fs_err}; refinement "
              f"one round at a time (half-pel, then quarter-pel) "
              f"equal={rf_same}, both rounds in one launch equal="
              f"{two_same}, on the search's own MVs equal={path_same}, "
              f"max_abs_err={rf_err}", flush=True)
        if not (fs_same and rf_same and two_same and path_same):
            raise SystemExit(f"ME kernels != plain at {label}")
        max_err["full_search"] = max(max_err["full_search"], fs_err)
        max_err["refine"] = max(max_err["refine"], rf_err)
        if label in ME_TIMED:
            plain_ms[label] = (fs_plain, rf_plain)
            calls = {
                "full_search": (lambda: MF.full_search_int_fast(
                    src, ref, lam, gw=gw, gh=gh, rng=rng), "k_full_search"),
                "refine": (lambda: MF.refine_subpel_rounds_fast(
                    src, ref, path_mv, path_part, lam, (2, 1), gw=gw, gh=gh,
                    nparts=4, hp=hp), "k_refine"),
                "refine_seeded": (lambda: MF.refine_subpel_rounds_fast(
                    src, ref, mv, part, lam, (2, 1), gw=gw, gh=gh, nparts=4,
                    hp=hp), "k_refine")}
            timed[label] = ({key: (event_ms(torch, fn, 10),
                                   kernel_us(torch, fn, 10, kname),
                                   host_us(fn, 10))
                             for key, (fn, kname) in calls.items()},
                            gw, gh, rng)
    for label, (t, gw, gh, rng) in timed.items():
        for key, what in (("full_search", "full search"),
                          ("refine", "refinement, both rounds, on the "
                           "search's MVs"),
                          ("refine_seeded", "refinement, both rounds, on "
                           "seeded MVs of every 4x4 block")):
            ms, dev_us, h_us = t[key]
            b, by = me_bound(gw, gh, rng, key[:6] if key != "full_search"
                             else key, clock)
            dev = "not measured" if dev_us is None else f"{dev_us:.1f} us"
            twin = plain_ms[label][key != "full_search"]
            print(f"[{card}] ME kernels {label}: {what} {ms * 1e3:.1f} "
                  f"us/picture with the wrapper, kernel alone {dev}, the "
                  f"wrapper's host time {h_us:.1f} us/call (plain torch "
                  f"{twin * 1e3:.1f} on seeded MVs, bound {b * 1e3:.3f} us, "
                  f"{by}; SM clock {clock / 1e9:.3f} GHz)", flush=True)
    t, gw, gh, rng = timed["720p"]
    return max_err, {key: (t[key][0], plain_ms["720p"][key == "refine"],
                           *me_bound(gw, gh, rng, key, clock))
                     for key in ("full_search", "refine")}


def outputs_diff(torch, got, want):
    """(max_abs_err, equal, the pairs of tensors) of two results, each a
    tensor or a tuple of tensors and Nones; equal means the same Nones,
    shapes, types and values."""
    g = got if isinstance(got, tuple) else (got,)
    w = want if isinstance(want, tuple) else (want,)
    pairs = [(a, b) for a, b in zip(g, w) if a is not None and b is not None]
    same = len(g) == len(w) and \
        all((a is None) == (b is None) for a, b in zip(g, w)) and \
        all(a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
            for a, b in pairs)
    err = max((abs_err(a, b) if a.shape == b.shape else float("inf")
               for a, b in pairs), default=0)
    return err, same, pairs


P_KERNELS = {"part_decide": "k_part_decide", "halfpel": "k_halfpel_enc",
             "p_residual": "k_p_residual",
             "deblock_params": "k_deblock_params"}
# the decoder's kernels outside the GOP kernel
DEC_KERNELS = {"intra_dec": "k_intra_decode",
               "deblock_params_dec": "k_deblock_params_dec",
               "residual_dec": "k_residual_dec", "mc_dec": "k_mc_dec",
               "ring_write_dec": "k_ring_write_dec"}
# the GOP scan's own kernels (csrc/mc_decode.cu)
MC_KERNELS = ("residual_dec", "mc_dec", "ring_write_dec")


def p_case_tensors(torch, k: int):
    """P_CASES[k]'s inputs (``p_inputs``, seed SEED + k) on the card:
    (label, gw, gh, a dict of tensors and ints)."""
    label, W, H, opts = P_CASES[k]
    gw, gh, c = p_inputs(W, H, SEED + k, **opts)

    def cuda(a):
        if a is None or isinstance(a, int):
            return a
        if isinstance(a, list):
            return [cuda(x) for x in a]
        return torch.tensor(a, device="cuda")
    return label, gw, gh, {n: cuda(v) for n, v in c.items()}


def p_check(torch, label, gw, gh, t):
    """The P-picture body's four kernels against their plain twins on one
    case, in the path's order: the full search (its kernel), the partition
    decision on its outputs, the half-pel stack of the reference, the
    refinement (its kernel) on both, the residual on the refined MVs (or
    the case's seeded ones) and the deblock parameters on the residual's
    levels with the case's intra map and edge flags.  Each wrapper is
    launched once.  Returns {kernel: (max_abs_err, equal, the twin's ms on
    its check run, a call of the wrapper on the same inputs)}."""
    from hartallo_tpu_torch.encode import e_device as E
    from hartallo_tpu_torch.encode import me_fast as MF
    from hartallo_tpu_torch.encode import p_body_fast as PB
    from hartallo_tpu_torch.encode import p_device as PD
    from hartallo_tpu_torch.ops.wide import halfpel_planes
    src, ref, lam, qp, cqo = t["src"], t["ref"], t["lam"], t["qp"], t["cqo"]
    out = {}

    def stage(name, fast, plain):
        got = fast()
        box = []
        ms = event_ms(torch, lambda: box.append(plain()), 1, warm=False)
        err, same, _ = outputs_diff(torch, got, box[0])
        out[name] = (err, same, ms, fast)
        return got

    fs = MF.full_search_int_fast(src[0], ref[0], lam, gw=gw, gh=gh,
                                 rng=t["rng"])
    _, best, mv, part = stage(
        "part_decide", lambda: PB.partition_decide_fast(fs, lam, gw=gw,
                                                        gh=gh),
        lambda: PD.partition_decide(fs, lam, gw=gw, gh=gh))
    hp = stage("halfpel", lambda: PB.halfpel_planes_fast(ref[0]),
               lambda: halfpel_planes(ref[0]))
    mv = MF.refine_subpel_rounds_fast(src[0], ref[0], mv, part, lam, (2, 1),
                                      gw=gw, gh=gh, nparts=4, hp=hp)[0] \
        if t["mv"] is None else t["mv"]
    wq = stage(
        "p_residual", lambda: PB.p_residual_fast(
            *src, *ref, mv, qp, best, lam, gw=gw, gh=gh, chroma_qp_off=cqo,
            intra_in_p=True),
        lambda: PD.p_residual(*src, *ref, mv, qp, best, lam, gw=gw, gh=gh,
                              chroma_qp_off=cqo, intra_in_p=True))[0]
    mv44 = mv.reshape(gh, gw, 4, 4, 2)
    ref44 = torch.zeros((gh, gw, 4, 4), dtype=torch.int32, device="cuda")
    flags = (t["fmb_v"], t["fmb_h"])
    stage("deblock_params", lambda: PB.deblock_params_fast(
        wq, mv44, ref44, t["intra"], qp, cqo, *flags, gw=gw, gh=gh),
        lambda: E.deblock_params(wq, mv44, ref44, t["intra"], qp, cqo,
                                 *flags, gw=gw, gh=gh))
    return out


def p_bound(kernel: str, gw: int, gh: int):
    """Bound of one call of a P-picture body kernel at gw x gh MBs, each
    input read once and each output written once.  part_decide: the full
    search's 27 words an MB read, the choice (int64), cost, 16 MVs and 16
    partition indices written; 16 operations an MB.  halfpel: the padded
    int32 plane read and the four written; three 6-tap filters (11
    operations each) and three roundings a sample.  p_residual: the
    source's and, at least, one reference sample per predicted sample
    read (int32), the MVs, qp and cost read, the levels (427 words an MB
    with the mask) and the padded recon planes written; 20 operations a
    sample (the transforms, quantisers and recon).  deblock_params: the
    luma levels, MVs, references, intra map and qp read, the int16
    rows written; 12 operations a bS."""
    nmb, H, W = gw * gh, gh * 16, gw * 16
    Hp, Wp, Hcp, Wcp = H + 64, W + 64, H // 2 + 64, W // 2 + 64
    if kernel == "part_decide":
        return bound(nmb * (27 * 4 + 8 + 4 + 128 + 64), 16 * nmb)
    if kernel == "halfpel":
        return bound(20 * Hp * Wp, 42 * Hp * Wp)
    if kernel == "p_residual":
        return bound(nmb * (2 * 384 * 4 + 128 + 8 + 1024 + 32 + 512 + 1) +
                     4 * (Hp * Wp + 2 * Hcp * Wcp), 20 * 384 * nmb)
    return bound(nmb * (1024 + 128 + 64 + 1 + 4 + 62 * 2), 12 * 32 * nmb)


def p_phase(torch, card):
    """The P-picture body kernels against their plain twins on P_CASES,
    tolerance 0 on every output (``p_check``; each twin timed on its
    check run); then at P_TIMED each kernel's time per picture with its
    wrapper (CUDA events), alone (the profiler's device time) and the
    wrapper's host time per call, beside its bound.  Returns (max_abs_err
    per kernel, and at 720p: each kernel's and twin's ms per picture and
    its bound)."""
    max_err = dict.fromkeys(P_KERNELS, 0)
    timed = {}
    for k in range(len(P_CASES)):
        label, gw, gh, t = p_case_tensors(torch, k)
        out = p_check(torch, label, gw, gh, t)
        print(f"P body kernel phase {label} ({gw}x{gh} MBs): " + "; ".join(
            f"{n} equal={same} max_abs_err={err}"
            for n, (err, same, _, _) in out.items()), flush=True)
        if not all(same for _, same, _, _ in out.values()):
            raise SystemExit(f"P body kernels != plain at {label}")
        for n, (err, _, _, _) in out.items():
            max_err[n] = max(max_err[n], err)
        if label in P_TIMED:
            timed[label] = ({n: (event_ms(torch, fn, 10),
                                 kernel_us(torch, fn, 10, P_KERNELS[n]),
                                 host_us(fn, 10), ms)
                             for n, (_, _, ms, fn) in out.items()}, gw, gh)
    floor = launch_floor_us(torch)
    print(f"[{card}] launch floor: a one-element fill takes "
          + ("not measured" if floor is None else f"{floor:.2f} us")
          + " on the card (profiler device time)", flush=True)
    for label, (t, gw, gh) in timed.items():
        for n, (ms, dev_us, h_us, plain) in t.items():
            b, by = p_bound(n, gw, gh)
            dev = "not measured" if dev_us is None else f"{dev_us:.1f} us"
            print(f"[{card}] P body kernel {n} {label}: {ms * 1e3:.1f} "
                  f"us/picture with the wrapper, kernel alone {dev}, the "
                  f"wrapper's host time {h_us:.1f} us/call, plain torch "
                  f"{plain * 1e3:.1f} us, bound {b * 1e3:.3f} us ({by})",
                  flush=True)
    t, gw, gh = timed["720p"]
    return max_err, {n: (t[n][0], t[n][3], *p_bound(n, gw, gh))
                     for n in P_KERNELS}


def decode_fixture(torch, name):
    """Decode a fixture through ``Codec`` on its default device, the card;
    every frame's MD5 must be the recorded one."""
    from hartallo_tpu_torch.api import Codec, CodecConfig
    stream, meta = load_fixture(name)
    codec = Codec(CodecConfig())
    t0 = time.perf_counter()
    out = codec.decode_annexb(stream, tolerant=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if codec.decoder.device.type != "cuda":
        raise SystemExit(f"{name}: Codec decoded on {codec.decoder.device}")
    md5 = [frame_md5(r.frame) for r in out]
    if md5 != meta["frame_md5"]:
        bad = [i for i, (a, b) in enumerate(zip(md5, meta["frame_md5"]))
               if a != b]
        raise SystemExit(f"{name}: {len(out)} frames, MD5 mismatch at "
                         f"{bad or 'frame count'}")
    return codec.decoder.stats, dt, meta["frames"]


DECODE_MAIN = ("cif_16", "720p_8", "1080p_8")
SVC = "svc3_4cif_8"


def dec_launches():
    """The launch counts of the decoder's kernels outside the GOP kernel:
    {intra_dec, deblock_params_dec, residual_dec, mc_dec, ring_write_dec,
    halfpel} (the half-pel stack and the MC count the encoder's launches
    too)."""
    from hartallo_tpu_torch.decode import intra_recon_fast as IDF
    from hartallo_tpu_torch.decode import mc_decode_fast as M
    from hartallo_tpu_torch.encode import p_body_fast as PB
    from hartallo_tpu_torch.ops import deblock_fast as D
    return {"intra_dec": IDF.LAUNCHES,
            "deblock_params_dec": D.PARAMS_LAUNCHES, **M.LAUNCHES,
            "halfpel": PB.LAUNCHES["halfpel"]}


def zero_dec_launches():
    from hartallo_tpu_torch.decode import intra_recon_fast as IDF
    from hartallo_tpu_torch.decode import mc_decode_fast as M
    from hartallo_tpu_torch.encode import p_body_fast as PB
    from hartallo_tpu_torch.ops import deblock_fast as D
    IDF.LAUNCHES = D.PARAMS_LAUNCHES = PB.LAUNCHES["halfpel"] = 0
    M.LAUNCHES.update(dict.fromkeys(M.LAUNCHES, 0))


def slice_phase(torch):
    """The decode path, launch counts set to 0 just before it: every
    picture of the CIF, 720p and 1080p fixtures takes the GOP kernel, and
    none of the decoder's other kernels runs."""
    from hartallo_tpu_torch.decode import d_gop_fast as F
    from hartallo_tpu_torch.ops import deblock_fast as D
    F.LAUNCHES = D.LAUNCHES = 0
    zero_dec_launches()
    stats = {name: decode_fixture(torch, name)[0] for name in DECODE_MAIN}
    launches, db, dec = F.LAUNCHES, D.LAUNCHES, dec_launches()
    print(f"slice phase: {stats}, GOP kernel launches (pictures) "
          f"{launches}, deblock kernel launches {db}, other decode kernel "
          f"launches {dec}", flush=True)
    for name, st in stats.items():
        nf = load_fixture(name)[1]["frames"]
        if st != {"kernel_pictures": nf, "scan_pictures": 0,
                  "general_pictures": 0}:
            raise SystemExit(f"{name}: expected {nf} kernel pictures and "
                             f"no scan picture, got {st}")
    if launches != sum(st["kernel_pictures"] for st in stats.values()):
        raise SystemExit(f"GOP kernel launches {launches} do not match the "
                         "pictures routed to it")
    if db != 0 or any(dec.values()):
        raise SystemExit(f"{db} deblock kernel launches and {dec} with no "
                         "GOP-scan picture")
    return launches


SCAN = ("qcif_6_wp", "720p_8_wp", "1080p_8_wp")


def scan_phase(torch):
    """The GOP-scan route on the card, launch counts set to 0 just before
    each fixture, every kernel call held against its plain twin
    (``TwinChecks``): each SCAN fixture (explicit weighted prediction on
    its P pictures, which the GOP kernel refuses) decodes to its MD5s
    with its IDR picture on the kernel and the others on the scan: one
    residual and one deblock parameter launch for each scan batch, an
    MC, a deblock and a ring write launch for each scan picture, an intra
    wavefront launch for each scan picture with an intra MB (both counted
    from the parsed pictures, ``DecodeWork``) and no half-pel stack;
    qcif_6_wp: 1 residual, 5 MC, 5 ring write, 1 intra wavefront and 1
    deblock parameter launch.  Returns the twin checks and the launches
    of all three."""
    from hartallo_tpu_torch.decode import d_gop_fast as F
    from hartallo_tpu_torch.ops import deblock_fast as D
    twins, work = TwinChecks(torch, "scan"), DecodeWork()
    total = {"gop": 0, "deblock": 0}
    for name in SCAN:
        F.LAUNCHES = D.LAUNCHES = 0
        zero_dec_launches()
        w0 = dict(work.counts)
        with twins, work:
            st, _, nf = decode_fixture(torch, name)
        launches, db, dec = F.LAUNCHES, D.LAUNCHES, dec_launches()
        w = {k: v - w0[k] for k, v in work.counts.items()}
        print(f"scan phase: {name} {st}, GOP kernel launches {launches}, "
              f"deblock kernel launches {db}, other decode kernel launches "
              f"{dec}; scan batches {w['scan_batches']}, scan pictures "
              f"with an intra MB {w['scan_intra']}", flush=True)
        n = nf - 1
        if st != {"kernel_pictures": 1, "scan_pictures": n,
                  "general_pictures": 0} or w["scan_pictures"] != n:
            raise SystemExit(f"{name}: expected 1 kernel / {n} scan "
                             f"pictures, got {st} and {w}")
        want = {"intra_dec": w["scan_intra"],
                "deblock_params_dec": w["scan_batches"],
                "residual_dec": w["scan_batches"], "mc_dec": n,
                "ring_write_dec": n, "halfpel": 0}
        if name == "qcif_6_wp" and want != {
                "intra_dec": 1, "deblock_params_dec": 1, "residual_dec": 1,
                "mc_dec": 5, "ring_write_dec": 5, "halfpel": 0}:
            raise SystemExit(f"qcif_6_wp: parsed pictures {w}")
        if launches != 1 or db != n or dec != want:
            raise SystemExit(f"{name}: {launches} GOP kernel, {db} deblock "
                             f"kernel and {dec} launches, expected 1, {n} "
                             f"and {want}")
        total["gop"] += launches
        total["deblock"] += db
        for k, v in dec.items():
            total[k] = total.get(k, 0) + v
    print(f"scan phase: == plain twin on {twins.calls}, MB grids "
          f"{ {k: sorted(v) for k, v in twins.shapes.items() if v} }, "
          f"max_abs_err {twins.err}", flush=True)
    checked = {k: twins.calls[k] for k in total}
    if checked != total:
        raise SystemExit(f"scan: twin checks {twins.calls} do not cover "
                         f"the path's launches {total}")
    return twins, total


class DecodeWork:
    """While in effect, what the decoder's kernels outside the GOP kernel
    must do, read from the parsed pictures and not from the wrappers:
    ``general`` the general-route pictures, ``intra_dec`` those with an
    Intra4x4 or Intra16x16 MB, ``deblock_params_dec`` those with an MB
    edge to filter (disable_deblocking_filter_idc other than 1 on some
    MB), ``shard_intra`` the band pictures of the sharded decode with
    an Intra4x4 or Intra16x16 MB (kinds 0 and 1 of the dense buffer), and
    of the GOP scan the batches (``scan_batches``), their pictures
    (``scan_pictures``) and those with an intra MB (``scan_intra``)."""

    def __init__(self):
        self.counts = dict.fromkeys(
            ("general", "intra_dec", "deblock_params_dec", "shard_intra",
             "scan_batches", "scan_pictures", "scan_intra"), 0)

    def __enter__(self):
        import numpy as np
        from hartallo_tpu_torch.decode import decoder as DM
        from hartallo_tpu_torch.decode.d_gop import _OFF
        from hartallo_tpu_torch.parallel import shard as S
        self.DM, self.S = DM, S
        self.real_general = DM.Decoder._reconstruct_general
        self.real_step = S.decode_frame_step_sharded
        self.real_scan = DM.decode_gop
        counts, real_general, real_step, real_scan = \
            self.counts, self.real_general, self.real_step, self.real_scan

        def general(dec, sps, pps, sh, nh, sd, *rest, **kw):
            counts["general"] += 1
            counts["intra_dec"] += bool(
                np.isin(sd.mb_kind, (DM.MB_I4X4, DM.MB_I16)).any())
            counts["deblock_params_dec"] += bool((sd.deblock_idc != 1).any())
            return real_general(dec, sps, pps, sh, nh, sd, *rest, **kw)

        def step(mesh, packed, *rest, **kw):
            kind = np.asarray(packed)[:, _OFF["kind"][0]] \
                .reshape(len(mesh.devices), -1)
            counts["shard_intra"] += sum(bool(np.isin(k, (0, 1)).any())
                                         for k in kind)
            return real_step(mesh, packed, *rest, **kw)
        def scan(packed, write_slot, has_intra, *rest, **kw):
            counts["scan_batches"] += 1
            counts["scan_pictures"] += len(write_slot)
            counts["scan_intra"] += int(np.sum(has_intra))
            return real_scan(packed, write_slot, has_intra, *rest, **kw)
        DM.Decoder._reconstruct_general = general
        S.decode_frame_step_sharded = step
        DM.decode_gop = scan
        return self

    def __exit__(self, *exc):
        self.DM.Decoder._reconstruct_general = self.real_general
        self.S.decode_frame_step_sharded = self.real_step
        self.DM.decode_gop = self.real_scan


GENERAL = ("qcif_6_sl", "pcm_64x48")


def general_phase(torch):
    """The general route on the card, launch counts set to 0 just before
    it, every kernel call held against its plain twin (``TwinChecks``):
    the GENERAL fixtures decode to their MD5s with every picture on the
    general route; an intra wavefront launch for each picture with an
    Intra4x4 or Intra16x16 MB (at least one in all), a deblock parameter
    launch and a deblock launch for each picture with an MB edge to
    filter (``DecodeWork``), no half-pel stack and no GOP kernel.
    Returns the twin checks and the launches."""
    from hartallo_tpu_torch.decode import d_gop_fast as F
    from hartallo_tpu_torch.ops import deblock_fast as D
    twins, work = TwinChecks(torch, "general route"), DecodeWork()
    F.LAUNCHES = D.LAUNCHES = 0
    zero_dec_launches()
    with twins, work:
        stats = {name: decode_fixture(torch, name)[0] for name in GENERAL}
    gop, db, dec, w = F.LAUNCHES, D.LAUNCHES, dec_launches(), work.counts
    print(f"general phase: {stats}; GOP kernel launches {gop}, deblock "
          f"kernel launches {db}, other decode kernel launches {dec}; from "
          f"the parsed pictures {w}; == plain twin on {twins.calls}, "
          f"max_abs_err {twins.err}", flush=True)
    frames = 0
    for name, st in stats.items():
        nf = load_fixture(name)[1]["frames"]
        frames += nf
        if st != {"kernel_pictures": 0, "scan_pictures": 0,
                  "general_pictures": nf}:
            raise SystemExit(f"{name}: expected {nf} general-route "
                             f"pictures, got {st}")
    want = {"intra_dec": w["intra_dec"],
            "deblock_params_dec": w["deblock_params_dec"],
            **dict.fromkeys(MC_KERNELS, 0), "halfpel": 0}
    if gop or db != w["deblock_params_dec"] or dec != want or \
            w["general"] != frames or not w["intra_dec"]:
        raise SystemExit(f"general route: {gop} GOP kernel, {db} deblock "
                         f"and {dec} launches for {w} (at least one intra "
                         "wavefront launch)")
    checked = {k: twins.calls[k] for k in ("deblock", *want)}
    if checked != {"deblock": db, **want}:
        raise SystemExit(f"general route: twin checks {twins.calls} do not "
                         "cover the path")
    return twins, {"deblock": db, **dec}


def encode_clip(torch, name):
    """Encode a fixture's clip on the card with bench.py's settings;
    returns (stream, seconds, metadata)."""
    from bench import make_clip
    from hartallo_tpu_torch.api import Codec, CodecConfig
    _, meta = load_fixture(name)
    W, H, NF = meta["width"], meta["height"], meta["frames"]
    clip = make_clip(W, H, NF)
    codec = Codec(CodecConfig(width=W, height=H, qp=30, gop_size=NF,
                              deblock=True, me_range=12))
    t0 = time.perf_counter()
    res = codec.encode_frames(clip, W, H)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return b"".join(r.headers + r.data for r in res), dt, meta


ENCODE_MAIN = ("cif_16", "720p_8", "1080p_8")


def encode_phase(torch):
    """The encode path, launch counts set to 0 just before it: each clip
    byte-equal to its fixture, the intra kernel launched once for the IDR
    picture and once for each P picture that took the intra branch
    (counted from the intra-in-P mask that the residual kernel's wrapper
    returns where ``p_device`` calls it), the full search, the partition
    decision, the half-pel stack, the refinement (both rounds) and the
    residual once each per P picture, the deblock parameters and the
    deblock kernel once per picture; then the port's decoder reads the
    port's streams back.  Returns (deblock launches, intra kernel
    launches, full search launches, refinement launches, the P body
    kernels' launches)."""
    from hartallo_tpu_torch.api import Codec, CodecConfig
    from hartallo_tpu_torch.decode import d_gop_fast as F
    from hartallo_tpu_torch.encode import intra_encode_fast as IF
    from hartallo_tpu_torch.encode import me_fast as MF
    from hartallo_tpu_torch.encode import p_body_fast as PB
    from hartallo_tpu_torch.encode import p_device as PD
    from hartallo_tpu_torch.ops import deblock_fast as D
    real_res, intra_p = PD.p_residual_fast, [0]

    def counted(*args, **kw):
        out = real_res(*args, **kw)
        intra_p[0] += bool(out[-1].any())        # the intra-in-P mask
        return out
    streams, counts = {}, {}
    F.LAUNCHES = D.LAUNCHES = IF.LAUNCHES = 0
    MF.FULL_SEARCH_LAUNCHES = MF.REFINE_LAUNCHES = 0
    PB.LAUNCHES.update(dict.fromkeys(PB.LAUNCHES, 0))
    PD.p_residual_fast = counted
    try:
        for name in ENCODE_MAIN:
            before = (IF.LAUNCHES, intra_p[0], MF.FULL_SEARCH_LAUNCHES,
                      MF.REFINE_LAUNCHES, D.LAUNCHES, dict(PB.LAUNCHES))
            streams[name] = encode_clip(torch, name)
            counts[name] = (IF.LAUNCHES - before[0], intra_p[0] - before[1],
                            MF.FULL_SEARCH_LAUNCHES - before[2],
                            MF.REFINE_LAUNCHES - before[3],
                            D.LAUNCHES - before[4],
                            {n: PB.LAUNCHES[n] - before[5][n]
                             for n in PB.LAUNCHES})
    finally:
        PD.p_residual_fast = real_res
    launches, intra = D.LAUNCHES, IF.LAUNCHES
    fs, rf = MF.FULL_SEARCH_LAUNCHES, MF.REFINE_LAUNCHES
    pb = dict(PB.LAUNCHES)
    pictures = sum(m["frames"] for _, _, m in streams.values())
    print(f"encode phase: {pictures} pictures, deblock kernel launches "
          f"{launches}, intra kernel launches {intra}, full search "
          f"launches {fs}, refinement launches {rf}, P body kernel "
          f"launches {pb}", flush=True)
    for name, (stream, _, meta) in streams.items():
        n, n_p, n_fs, n_rf, n_db, n_pb = counts[name]
        n_pic = meta["frames"] - 1
        print(f"encode phase {name}: intra kernel launches {n}, P pictures "
              f"with intra MBs {n_p} of {n_pic}; full search launches "
              f"{n_fs}, refinement launches {n_rf}, deblock kernel "
              f"launches {n_db}, P body kernel launches {n_pb}", flush=True)
        if n != 1 + n_p:
            raise SystemExit(f"{name}: {n} intra kernel launches for one "
                             f"IDR picture and {n_p} P pictures with intra "
                             "MBs")
        if (n_fs, n_rf) != (n_pic, n_pic):
            raise SystemExit(f"{name}: {n_fs} full search and {n_rf} "
                             f"refinement launches for {n_pic} P pictures")
        want_pb = {"part_decide": n_pic, "halfpel": n_pic,
                   "p_residual": n_pic, "deblock_params": meta["frames"]}
        if n_pb != want_pb or n_db != meta["frames"]:
            raise SystemExit(f"{name}: P body kernel launches {n_pb} and "
                             f"{n_db} deblock launches; expected {want_pb} "
                             f"and {meta['frames']}")
        want, _ = load_fixture(name)
        if stream != want:
            raise SystemExit(f"{name}: the port's stream ({len(stream)} "
                             f"bytes) differs from the fixture "
                             f"({len(want)} bytes)")
        out = Codec(CodecConfig()).decode_annexb(stream, tolerant=False)
        md5 = [frame_md5(r.frame) for r in out]
        if md5 != meta["frame_md5"]:
            raise SystemExit(f"{name}: the port's decode of its own stream "
                             "misses the recorded MD5s")
        print(f"encode phase {name}: {len(stream)} bytes, byte-equal to "
              f"the fixture; round trip MD5s equal", flush=True)
    return launches, intra, fs, rf, pb


def p_picture_kernels(torch, card):
    """The device kernels that one P picture of the CIF clip launches, from
    ``torch.profiler`` (``tools/port_stages.p_picture_kernels``): the hand
    kernels of ``csrc`` and the rest (PyTorch's own, the eager ops')."""
    from port_stages import p_picture_kernels as kernels_of
    got = kernels_of(352, 288)
    print(f"[{card}] one CIF P picture's device kernels (profiler): "
          f"{json.dumps(got)}", flush=True)
    if not got["hand"]:
        raise SystemExit("the profiler saw no hand kernel in a P picture")
    return got


def svc_clips(meta):
    """The I420 clip of each layer of the SVC fixture, lowest first:
    ``bench.make_clip`` at the top layer's size, each lower layer the
    port's ``downsample_dyadic_np`` of the one above (the fixture's
    layers are dyadic)."""
    import numpy as np
    from bench import make_clip
    from hartallo_tpu_torch.svc.upsample import downsample_dyadic_np
    layers, nf = meta["layers"], meta["frames"]
    clips = [make_clip(*layers[-1], nf)]
    for (w, h), (uw, uh) in zip(layers[-2::-1], layers[:0:-1]):
        if (2 * w, 2 * h) != (uw, uh):
            raise SystemExit(f"{SVC}: layer {w}x{h} is not dyadic")
        frames = []
        for f in clips[0]:
            planes = (f[:uw * uh].reshape(uh, uw),
                      f[uw * uh:uw * uh * 5 // 4].reshape(uh // 2, uw // 2),
                      f[uw * uh * 5 // 4:].reshape(uh // 2, uw // 2))
            frames.append(np.concatenate(
                [downsample_dyadic_np(p).ravel() for p in planes]))
        clips.insert(0, frames)
    return clips


def svc_encode(torch, meta, clips):
    """Encode the SVC clips on the card through ``Codec.encode``, each
    picture of every layer in turn; returns (stream, seconds)."""
    from hartallo_tpu_torch.api import Codec, CodecConfig
    cfg = CodecConfig(qp=meta["qp"], gop_size=meta["gop_size"],
                      deblock=meta["deblock"], me_range=meta["me_range"],
                      temporal_layers=meta["temporal_layers"])
    for w, h in meta["layers"]:
        cfg.add_layer(w, h)
    codec = Codec(cfg)
    t0 = time.perf_counter()
    out = b""
    for t in range(meta["frames"]):
        for (w, h), clip in zip(meta["layers"], clips):
            r = codec.encode(clip[t], w, h)
            out += r.headers + r.data
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def svc_decode(torch, stream, **window):
    """Decode the SVC fixture through ``Codec`` on the card; returns
    (results, route stats, seconds)."""
    from hartallo_tpu_torch.api import Codec, CodecConfig
    codec = Codec(CodecConfig(**window))
    t0 = time.perf_counter()
    out = codec.decode_annexb(stream, tolerant=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if codec.decoder.device.type != "cuda":
        raise SystemExit(f"{SVC}: Codec decoded on {codec.decoder.device}")
    return out, codec.decoder.stats, dt


class TwinChecks:
    """While in effect, every call the path makes to a kernel's wrapper,
    where the port calls it (``decoder.decode_gop_fast``,
    ``e_device.deblock_frame_aux_fast`` for the encoder's in-loop deblock,
    ``decoder.deblock_frame_aux_fast`` for the decoder's general route and
    ``d_gop.deblock_frame_aux_fast`` for the GOP scan and the sharded
    decode, each on gathered parameters, ``d_gop.deblock_params_dec_fast``
    and ``decoder.deblock_params_dec_fast`` for the decoder's deblock
    parameters, ``d_gop.intra_reconstruct_fast`` and
    ``decoder.intra_reconstruct_fast`` for the decoder's intra wavefront,
    ``e_device.intra_encode_frame_fast`` for the encoder,
    ``p_device.full_search_int_fast`` and ``refine_subpel_rounds_fast`` for
    the encoder's motion search, ``p_device.partition_decide_fast``,
    ``halfpel_planes_fast`` and ``p_residual_fast`` and
    ``e_device.deblock_params_fast`` for the rest of its P-picture body,
    and ``halfpel_planes_fast`` where the decoder builds a reference's
    stack: ``d_gop``, ``decoder`` and ``parallel/shard``, and the SVC
    encoder's inter-layer prediction's, ``svc``;
    ``d_gop.residual_planes_fast``, ``mc_recon_fast`` and
    ``ring_write_fast`` for the GOP scan and the sharded band step, and
    ``svc.mc_recon_fast`` for the inter-layer prediction), is held against
    the plain twin on the same inputs, tolerance 0: the GOP kernel's
    output and ring (the ring cloned before the call), the deblocked
    planes, the parameter rows, the intra wavefront's planes, the intra
    encode's eleven outputs, the full search's eight outputs, the
    refinement's MVs and costs (against the twin's chain of its rounds),
    every output of the four P body kernels, the residual planes, the MC's
    three planes, and the ring write's whole rings and output row (the
    twin on clones taken before the call).  The twins launch
    nothing, so the launch counts stay the path's.  The deblock and the
    intra wavefront twins (some 150,000 and 200,000 small ops at a 1080p
    band grid) run through ``ops/graphs.replayed``: eager ops the first
    time their input shapes are seen, the same ops recorded into a CUDA
    graph the second time and replayed after that.  ``calls`` and
    ``err`` (max_abs_err) per kernel, ``shapes`` the (gw, gh) grids seen,
    ``decode_halfpel`` the half-pel stacks the decoder asked for;
    ``label`` names the path in an error."""

    def __init__(self, torch, label):
        from hartallo_tpu_torch.decode import d_gop as G
        from hartallo_tpu_torch.decode import decoder as DM
        from hartallo_tpu_torch.encode import e_device as E
        from hartallo_tpu_torch.encode import p_device as PD
        from hartallo_tpu_torch.encode import svc as SV
        from hartallo_tpu_torch.parallel import shard as S
        self.torch, self.DM, self.E, self.G, self.PD, self.S, self.SV = \
            torch, DM, E, G, PD, S, SV
        self.label = label
        kernels = ("gop", "deblock", "intra", "full_search", "refine",
                   *P_KERNELS, *DEC_KERNELS)
        self.calls = dict.fromkeys(kernels, 0)
        self.err = dict.fromkeys(kernels, 0)
        self.shapes = {k: set() for k in kernels}
        self.decode_halfpel = 0

    def _gop(self, *args, gw, gh, **kw):
        from hartallo_tpu_torch.decode import d_gop_fast as F
        torch = self.torch
        rings = [r.clone() for r in args[7:]]
        out, *rk = self.real_gop(*args, gw=gw, gh=gh, **kw)
        op, *rp = F.decode_gop_fast_plain(*args[:7], *rings, gw=gw, gh=gh,
                                          **kw)
        Hp, Wp, Hcp, Wcp = gh * 16 + 64, gw * 16 + 64, gh * 8 + 64, \
            gw * 8 + 64
        same = torch.equal(out, op) and \
            torch.equal(rk[0][:, :, :Hp, :Wp], rp[0][:, :, :Hp, :Wp]) and \
            all(torch.equal(a[:, :Hcp, :Wcp], b[:, :Hcp, :Wcp])
                for a, b in zip(rk[1:], rp[1:]))
        self._record("gop", gw, gh, [(out, op)], same)
        return (out, *rk)

    def _deblock_aux(self, planes, aux, *, gw, gh):
        from hartallo_tpu_torch.ops import deblock_fast as D
        from hartallo_tpu_torch.ops.graphs import replayed

        def plain(pY, pU, pV, aux):
            return D.deblock_frame_aux_plain((pY, pU, pV), aux, gw=gw,
                                             gh=gh)
        got = self.real_db_aux(planes, aux, gw=gw, gh=gh)
        want = replayed(plain, "deblock_frame_aux_plain", *planes, aux)
        same = all(self.torch.equal(g, w) for g, w in zip(got, want))
        self._record("deblock", gw, gh, list(zip(got, want)), same)
        return got

    def _intra_dec(self, planes, *rest, gw, gh):
        from hartallo_tpu_torch.decode.intra_recon import intra_reconstruct
        from hartallo_tpu_torch.ops.graphs import replayed
        torch = self.torch
        # the twin's inputs as one fixed set of tensors: replayed keys its
        # graph on them (avail_tr None is all true)
        maps = list(rest)
        if len(maps) < 9 or maps[8] is None:
            maps[8:] = [torch.ones_like(maps[6], dtype=torch.bool)]
        maps = [m.to(torch.bool if i >= 6 else torch.int32).contiguous()
                for i, m in enumerate(maps)]

        def plain(pY, pU, pV, *m):
            return intra_reconstruct((pY, pU, pV), *m, gw=gw, gh=gh)
        got = self.real_intra_dec(planes, *rest, gw=gw, gh=gh)
        want = replayed(plain, "intra_reconstruct",
                        *(p.to(torch.int32).contiguous() for p in planes),
                        *maps)
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        self._record("intra_dec", gw, gh, list(zip(got, want)), same)
        return got

    def _params_dec(self, rec, offsets, cqo, *, gw, gh):
        from hartallo_tpu_torch.ops import deblock_fast as D
        got = self.real_params_dec(rec, offsets, cqo, gw=gw, gh=gh)
        want = D.deblock_params_dec_plain(rec, offsets, cqo, gw=gw, gh=gh)
        self._record("deblock_params_dec", gw, gh, [(got, want)],
                     self.torch.equal(got, want))
        return got

    def _residual_dec(self, rec, offsets, cqo, *, gw, gh):
        from hartallo_tpu_torch.decode import mc_decode_fast as M
        got = self.real_residual(rec, offsets, cqo, gw=gw, gh=gh)
        want = M.residual_planes_plain(rec, offsets, cqo, gw=gw, gh=gh)
        _, same, pairs = outputs_diff(self.torch, got, want)
        self._record("residual_dec", gw, gh, pairs, same)
        return got

    def _mc_dec(self, *args, gw, gh):
        from hartallo_tpu_torch.decode import mc_decode_fast as M
        got = self.real_mc(*args, gw=gw, gh=gh)
        _, same, pairs = outputs_diff(self.torch, got,
                                      M.mc_recon_plain(*args, gw=gw, gh=gh))
        self._record("mc_dec", gw, gh, pairs, same)
        return got

    def _ring_write(self, y2, u2, v2, ringY, ringU, ringV, ws, out, *, gw,
                    gh):
        from hartallo_tpu_torch.decode import mc_decode_fast as M
        rings = [r.clone() for r in (ringY, ringU, ringV)]
        want = out.clone()
        got = self.real_ring(y2, u2, v2, ringY, ringU, ringV, ws, out,
                             gw=gw, gh=gh)
        M.ring_write_plain(y2, u2, v2, *rings, ws, want, gw=gw, gh=gh)
        _, same, pairs = outputs_diff(
            self.torch, (ringY, ringU, ringV, got), (*rings, want))
        self._record("ring_write_dec", gw, gh, pairs, same)
        return got

    def _p_body(self, kernel, real, plain, decode=False):
        """A checked call of the P body kernel ``kernel``: the wrapper
        ``real``, the twin ``plain`` on the same arguments (``decode``:
        a call of the decoder's)."""
        def call(*args, **kw):
            got = real(*args, **kw)
            _, same, pairs = outputs_diff(self.torch, got,
                                          plain(*args, **kw))
            gw, gh = kw.get("gw"), kw.get("gh")
            if gw is None:            # the half-pel stack: its plane's grid
                gh, gw = ((n - 64) // 16 for n in args[0].shape)
            self._record(kernel, gw, gh, pairs, same)
            self.decode_halfpel += decode
            return got
        return call

    def _intra(self, *args, gw, gh, **kw):
        from hartallo_tpu_torch.encode import intra_encode_fast as IF
        got = self.real_intra(*args, gw=gw, gh=gh, **kw)
        want = IF.intra_encode_frame(*args, gw=gw, gh=gh, **kw)
        pairs = [(g, w) for _, g, w in intra_pairs(got, want)]
        self._record("intra", gw, gh, pairs,
                     all(self.torch.equal(a, b) for a, b in pairs))
        return got

    def _full_search(self, *args, gw, gh, **kw):
        from hartallo_tpu_torch.encode import me as M
        got = self.real_fs(*args, gw=gw, gh=gh, **kw)
        want = M.full_search_int(*args, gw=gw, gh=gh, **kw)
        self._record("full_search", gw, gh, list(zip(got, want)),
                     me_diff(got, want)[1])
        return got

    def _refine(self, src, ref, mv, part, lam, steps, *, gw, gh, **kw):
        from hartallo_tpu_torch.encode import me as M
        got = self.real_rf(src, ref, mv, part, lam, steps, gw=gw, gh=gh,
                           **kw)
        want = (mv, None)
        for step in steps:
            want = M.refine_subpel(src, ref, want[0], part, lam, step,
                                   gw=gw, gh=gh, **kw)
        self._record("refine", gw, gh, list(zip(got, want)),
                     me_diff(got, want)[1])
        return got

    def _record(self, kernel, gw, gh, pairs, same):
        err = max(abs_err(a, b) if a.shape == b.shape else float("inf")
                  for a, b in pairs)
        if not same:
            raise SystemExit(f"{self.label}: the {kernel} kernel differs "
                             f"from its plain twin at {gw}x{gh} MBs on the "
                             f"path (max_abs_err {err})")
        self.calls[kernel] += 1
        self.err[kernel] = max(self.err[kernel], err)
        self.shapes[kernel].add((gw, gh))

    def _sites(self):
        """(module, wrapper name, the checked call) of every call site."""
        from hartallo_tpu_torch.ops.wide import halfpel_planes
        E, PD, G, DM, S, SV = self.E, self.PD, self.G, self.DM, self.S, \
            self.SV
        p_body = [(PD, "partition_decide_fast", "part_decide",
                   PD.partition_decide, False),
                  (PD, "halfpel_planes_fast", "halfpel", halfpel_planes,
                   False),
                  (PD, "p_residual_fast", "p_residual", PD.p_residual,
                   False),
                  (E, "deblock_params_fast", "deblock_params",
                   E.deblock_params, False),
                  *((mod, "halfpel_planes_fast", "halfpel", halfpel_planes,
                     True) for mod in (DM, S)),
                  (SV, "halfpel_planes_fast", "halfpel", halfpel_planes,
                   False)]
        sites = [(mod, name, self._p_body(kernel, getattr(mod, name), plain,
                                          decode))
                 for mod, name, kernel, plain, decode in p_body]
        sites += [(DM, "decode_gop_fast", self._gop),
                  (E, "deblock_frame_aux_fast", self._deblock_aux),
                  (G, "deblock_frame_aux_fast", self._deblock_aux),
                  (DM, "deblock_frame_aux_fast", self._deblock_aux),
                  (E, "intra_encode_frame_fast", self._intra),
                  (PD, "full_search_int_fast", self._full_search),
                  (PD, "refine_subpel_rounds_fast", self._refine),
                  (G, "intra_reconstruct_fast", self._intra_dec),
                  (DM, "intra_reconstruct_fast", self._intra_dec),
                  (G, "deblock_params_dec_fast", self._params_dec),
                  (DM, "deblock_params_dec_fast", self._params_dec),
                  (G, "residual_planes_fast", self._residual_dec),
                  (G, "mc_recon_fast", self._mc_dec),
                  (SV, "mc_recon_fast", self._mc_dec),
                  (G, "ring_write_fast", self._ring_write)]
        return sites

    def __enter__(self):
        self.real_gop = self.DM.decode_gop_fast
        self.real_db_aux = self.E.deblock_frame_aux_fast
        self.real_intra = self.E.intra_encode_frame_fast
        self.real_fs, self.real_rf = self.PD.full_search_int_fast, \
            self.PD.refine_subpel_rounds_fast
        self.real_intra_dec = self.G.intra_reconstruct_fast
        self.real_params_dec = self.G.deblock_params_dec_fast
        self.real_residual = self.G.residual_planes_fast
        self.real_mc = self.G.mc_recon_fast
        self.real_ring = self.G.ring_write_fast
        sites = self._sites()
        self.saved = [(mod, name, getattr(mod, name))
                      for mod, name, _ in sites]
        for mod, name, checked in sites:
            setattr(mod, name, checked)
        return self

    def __exit__(self, *exc):
        for mod, name, real in self.saved:
            setattr(mod, name, real)


def svc_phase(torch):
    """The SVC round trip, launch counts set to 0 just before it: encode
    byte-equal to the fixture, every decode to its MD5s, the launches
    matching the routes; in the encode and the full decode, every kernel
    call held against its plain twin (``TwinChecks``).  Returns (GOP
    kernel launches, deblock kernel launches, intra kernel launches, full
    search and refinement launches, stream, clips, the twin checks, the
    P body kernels' launches (the half-pel stack's with the decodes'),
    the decoder's intra wavefront and deblock parameter launches)."""
    from hartallo_tpu_torch.decode import d_gop_fast as F
    from hartallo_tpu_torch.encode import intra_encode_fast as IF
    from hartallo_tpu_torch.encode import me_fast as MF
    from hartallo_tpu_torch.encode import p_body_fast as PB
    from hartallo_tpu_torch.ops import deblock_fast as D
    stream, meta = load_fixture(SVC)
    clips = svc_clips(meta)
    twins, work = TwinChecks(torch, SVC), DecodeWork()
    F.LAUNCHES = D.LAUNCHES = IF.LAUNCHES = 0
    MF.FULL_SEARCH_LAUNCHES = MF.REFINE_LAUNCHES = 0
    PB.LAUNCHES.update(dict.fromkeys(PB.LAUNCHES, 0))
    zero_dec_launches()
    with twins:
        mine, _ = svc_encode(torch, meta, clips)
    enc_db, intra = D.LAUNCHES, IF.LAUNCHES
    ilp = dec_launches()["mc_dec"]          # inter-layer predictions
    me = (MF.FULL_SEARCH_LAUNCHES, MF.REFINE_LAUNCHES)
    pb = dict(PB.LAUNCHES)
    if mine != stream:
        raise SystemExit(f"{SVC}: the port's stream ({len(mine)} bytes) "
                         f"differs from the fixture ({len(stream)} bytes)")
    routes, kernel_pictures, dec, parsed = {}, 0, {}, {}
    for key, window in (("frame_md5", {}), ("dqid_max0_md5",
                                           {"dqid_max": 0}),
                        ("tid_max0_md5", {"tid_max": 0})):
        before, w0 = dec_launches(), dict(work.counts)
        with work:
            if window:
                out, st, _ = svc_decode(torch, stream, **window)
            else:
                with twins:
                    out, st, _ = svc_decode(torch, stream)
        dec[key] = {k: v - before[k] for k, v in dec_launches().items()}
        parsed[key] = {k: v - w0[k] for k, v in work.counts.items()}
        if [frame_md5(r.frame) for r in out] != meta[key]:
            raise SystemExit(f"{SVC} {window or 'full'} decode: MD5 "
                             "mismatch")
        if not window and [r.dqid for r in out] != meta["frame_dqid"]:
            raise SystemExit(f"{SVC}: output DQIds differ")
        routes[key] = st
        kernel_pictures += st["kernel_pictures"]
    launches, db = F.LAUNCHES, D.LAUNCHES
    general = sum(st["general_pictures"] for st in routes.values())
    encoded = meta["frames"] * len(meta["layers"])
    print(f"SVC phase: {SVC} encoded byte-equal to the fixture "
          f"({len(mine)} bytes, {encoded} pictures, {enc_db} deblock "
          f"kernel launches); decodes (full, dqid_max=0, tid_max=0) equal "
          f"to the MD5s; routes {routes}; GOP kernel launches {launches}, "
          f"deblock kernel launches in the decodes {db - enc_db} for "
          f"{general} general-route pictures", flush=True)
    print(f"SVC phase: intra kernel launches in the encode {intra}, full "
          f"search launches {me[0]}, refinement launches {me[1]}, P body "
          f"kernel launches {pb}; the decodes' intra wavefront, deblock "
          f"parameter and half-pel stack launches {dec}, from their parsed "
          f"pictures {parsed}", flush=True)
    for kernel in twins.calls:
        print(f"SVC phase: {kernel} kernel == plain twin on "
              f"{twins.calls[kernel]} calls of the encode and the full "
              f"decode, MB grids {sorted(twins.shapes[kernel])}, "
              f"max_abs_err {twins.err[kernel]}", flush=True)
    if launches != kernel_pictures:
        raise SystemExit(f"SVC: {launches} GOP kernel launches for "
                         f"{kernel_pictures} kernel-route pictures")
    if enc_db != encoded:
        raise SystemExit(f"SVC: {enc_db} deblock kernel launches for "
                         f"{encoded} encoded pictures")
    if db - enc_db != general:
        raise SystemExit(f"SVC: {db - enc_db} deblock kernel launches in "
                         f"the decodes for {general} general-route pictures")
    if twins.calls["deblock"] != encoded + routes["frame_md5"][
            "general_pictures"] or not twins.calls["gop"] or \
            not intra or twins.calls["intra"] != intra:
        raise SystemExit(f"SVC: twin checks {twins.calls} do not cover the "
                         f"encode and the full decode ({intra} intra kernel "
                         "launches)")
    if not me[0] or me[1] != me[0] or \
            (twins.calls["full_search"], twins.calls["refine"]) != me:
        raise SystemExit(f"SVC: {me[0]} full search and {me[1]} refinement "
                         f"launches, twin checks {twins.calls}")
    want_pb = {"part_decide": me[0], "halfpel": me[1] + ilp,
               "p_residual": me[0], "deblock_params": enc_db}
    full = dec["frame_md5"]
    if pb != want_pb or any(twins.calls[n] != pb[n] for n in pb
                            if n != "halfpel") or \
            twins.calls["halfpel"] != pb["halfpel"] + full["halfpel"] or \
            twins.decode_halfpel != full["halfpel"]:
        raise SystemExit(f"SVC: P body kernel launches {pb}, expected "
                         f"{want_pb}, and {full['halfpel']} half-pel stacks "
                         f"in the full decode; twin checks {twins.calls}")
    # the decodes: a deblock parameter launch for each general-route
    # picture with an edge to filter, an intra wavefront launch for each
    # with an Intra4x4 or Intra16x16 MB, each held against its twin in the
    # full decode
    if any(d["deblock_params_dec"] != parsed[k]["deblock_params_dec"] or
           d["intra_dec"] != parsed[k]["intra_dec"] or
           parsed[k]["general"] != routes[k]["general_pictures"]
           for k, d in dec.items()) or \
            (twins.calls["intra_dec"], twins.calls["deblock_params_dec"]) \
            != (full["intra_dec"], full["deblock_params_dec"]):
        raise SystemExit(f"SVC: decode launches {dec} for routes {routes} "
                         f"and parsed pictures {parsed}; twin checks "
                         f"{twins.calls}")
    # the GOP scan's kernels: an MC and a ring write launch for each scan
    # picture of a decode
    if any(d[k] != routes[key]["scan_pictures"] for key, d in dec.items()
           for k in ("mc_dec", "ring_write_dec")) or \
            (twins.calls["mc_dec"] - ilp, twins.calls["ring_write_dec"],
             twins.calls["residual_dec"]) != (
                full["mc_dec"], full["ring_write_dec"], full["residual_dec"]):
        raise SystemExit(f"SVC: decode launches {dec} for routes {routes}; "
                         f"twin checks {twins.calls}")
    pb["halfpel"] += sum(d["halfpel"] for d in dec.values())
    # the MC kernel's launches: the decodes' and the encode's inter-layer
    # predictions
    return launches, db, intra, me, stream, clips, twins, pb, \
        {k: sum(d[k] for d in dec.values()) + (ilp if k == "mc_dec" else 0)
         for k in DEC_KERNELS}


def svc_fps(torch, card, stream, clips):
    """Best and worst of 3 SVC encodes and decodes after a warm-up (the
    SVC phase's runs), in access units (one picture of each layer) and in
    pictures per second."""
    meta = load_fixture(SVC)[1]
    nl, nf = len(meta["layers"]), meta["frames"]
    enc = [nf / svc_encode(torch, meta, clips)[1] for _ in range(3)]
    dec = [nf / svc_decode(torch, stream)[2] for _ in range(3)]
    for what, runs in (("encode", enc), ("decode", dec)):
        print(f"[{card}] {SVC} port SVC {what}: access units/s best "
              f"{max(runs):.2f} worst {min(runs):.2f} (pictures/s "
              f"{max(runs) * nl:.2f} / {min(runs) * nl:.2f}; 3 runs after "
              f"a warm-up)", flush=True)


SVC_QUALITY = "svc_quality_4"


def ilp_phase(torch):
    """The SVC encoder's inter-layer prediction (``svc._ilp_predict``) on
    the card, launch counts set to 0 just before it: ``svc_quality_4``
    (one QCIF layer with a quality refinement layer, 4 pictures, the
    ``bench.make_clip`` clip) encoded through ``Codec.encode`` byte-equal
    to the fixture, one MC launch and one half-pel stack (besides the
    refinement's) for each refined P picture, every call of any kernel
    held against its plain twin (``TwinChecks``).  Returns (the twin
    checks, the MC launches, the half-pel stacks of the prediction)."""
    from bench import make_clip
    from hartallo_tpu_torch.api import Codec, CodecConfig
    from hartallo_tpu_torch.decode import d_gop_fast as F
    from hartallo_tpu_torch.encode import me_fast as MF
    from hartallo_tpu_torch.encode import p_body_fast as PB
    from hartallo_tpu_torch.ops import deblock_fast as D
    stream, meta = load_fixture(SVC_QUALITY)
    (W, H), = meta["layers"]
    cfg = CodecConfig(width=W, height=H, **{
        k: meta[k] for k in ("qp", "gop_size", "deblock", "me_range",
                             "quality_layers", "quality_qp_delta")})
    clip = make_clip(W, H, meta["frames"])
    twins = TwinChecks(torch, SVC_QUALITY)
    F.LAUNCHES = D.LAUNCHES = 0
    MF.FULL_SEARCH_LAUNCHES = MF.REFINE_LAUNCHES = 0
    PB.LAUNCHES.update(dict.fromkeys(PB.LAUNCHES, 0))
    zero_dec_launches()
    with twins:
        codec = Codec(cfg)
        out = b"".join(r.headers + r.data for r in
                       (codec.encode(f, W, H) for f in clip))
    torch.cuda.synchronize()
    dec = dec_launches()
    mc, hp = dec["mc_dec"], dec["halfpel"] - MF.REFINE_LAUNCHES
    print(f"ILP phase: {SVC_QUALITY} encoded byte-equal to the fixture "
          f"{out == stream} ({len(out)} bytes); MC launches {mc}, half-pel "
          f"stacks of the prediction {hp}; == plain twin on "
          f"{ {k: v for k, v in twins.calls.items() if v} }, max_abs_err "
          f"{ {k: v for k, v in twins.err.items() if twins.calls[k]} }",
          flush=True)
    if out != stream:
        raise SystemExit(f"{SVC_QUALITY}: the port's stream differs from "
                         "the fixture")
    n = meta["frames"] - 1
    if mc != n or hp != n or twins.calls["mc_dec"] != mc or \
            twins.calls["halfpel"] != dec["halfpel"] or \
            dec["residual_dec"] or dec["ring_write_dec"]:
        raise SystemExit(f"{SVC_QUALITY}: launches {dec}, twin checks "
                         f"{twins.calls}; expected {n} MC launches and "
                         f"{n} prediction half-pel stacks")
    return twins, mc, hp


SHARD = "shard_1080p_8"
SHARD_P = "shard_p_1080p"
SHARD_BANDS = 4          # Mesh(("cuda:0",) * 4): four bands on the card


def shard_p_planes():
    """The sharded P step's inputs as ``tools/make_port_fixtures.py`` made
    them for the JAX package, through the port's ``pack_src``."""
    from bench import make_clip
    from hartallo_tpu_torch.encode.e_device import pack_src
    from make_port_fixtures import shard_p_inputs
    return shard_p_inputs(pack_src, make_clip)


def shard_step(torch, mesh, planes, meta):
    """One sharded 1080p P step on ``mesh``, synchronised."""
    import numpy as np
    from hartallo_tpu_torch.parallel.shard import p_encode_step_sharded
    out = p_encode_step_sharded(
        mesh, *planes, np.full((meta["gh"], meta["gw"]), meta["qp"],
                               np.int32), meta["lam"], gw=meta["gw"],
        gh=meta["gh"], rng=meta["rng"])
    torch.cuda.synchronize()
    return out


def shard_decode(torch, mesh, stream):
    """The grouped sharded decode (2 groups) of a stream on ``mesh``;
    returns (frames, seconds)."""
    from hartallo_tpu_torch.parallel.shard import decode_gops_grouped
    t0 = time.perf_counter()
    frames = decode_gops_grouped(mesh, stream, groups=2)
    torch.cuda.synchronize()
    return frames, time.perf_counter() - t0


def shard_phase(torch):
    """The row-sharded path on ``Mesh(("cuda:0",) * 4)``, launch counts
    set to 0 just before it: the 1080p P step's eight outputs equal the
    JAX package's MD5s (4 deblock launches, 4 full search and 4
    refinement launches, one each per band), and the grouped decode of
    shard_1080p_8 (2 GOPs on 2 groups of 2 bands of 34 MB rows) equals
    every frame's MD5 (2 bands x 8 pictures = 16 deblock and 16 deblock
    parameter launches, an intra wavefront launch for each band picture
    with an intra MB, a half-pel stack for each ring slot of each band
    picture, no GOP kernel); every kernel call of both held against its
    plain twin (``TwinChecks``).  Returns (deblock launches, full
    search and refinement launches, the twin checks, the P-step
    inputs, the P body kernels' launches (the half-pel stack's with the
    decode's), the decoder's intra wavefront and deblock parameter
    launches)."""
    from hartallo_tpu_torch.decode import d_gop_fast as F
    from hartallo_tpu_torch.encode import me_fast as MF
    from hartallo_tpu_torch.encode import p_body_fast as PB
    from hartallo_tpu_torch.ops import deblock_fast as D
    from hartallo_tpu_torch.parallel.shard import Mesh, gather
    from make_port_fixtures import int32_md5
    pmeta = json.loads((FIXTURES / f"{SHARD_P}.json").read_text())
    stream, meta = load_fixture(SHARD)
    planes = shard_p_planes()
    mesh = Mesh(("cuda:0",) * SHARD_BANDS)
    twins, work = TwinChecks(torch, "shard"), DecodeWork()
    F.LAUNCHES = D.LAUNCHES = 0
    MF.FULL_SEARCH_LAUNCHES = MF.REFINE_LAUNCHES = 0
    PB.LAUNCHES.update(dict.fromkeys(PB.LAUNCHES, 0))
    zero_dec_launches()
    with twins:
        out = shard_step(torch, mesh, planes, pmeta)
        enc_db, enc_pb = D.LAUNCHES, dict(PB.LAUNCHES)
        with work:
            frames, _ = shard_decode(torch, mesh, stream)
    db, gop = D.LAUNCHES, F.LAUNCHES
    me = (MF.FULL_SEARCH_LAUNCHES, MF.REFINE_LAUNCHES)
    pb, dec = dict(PB.LAUNCHES), dec_launches()
    dec["halfpel"] -= enc_pb["halfpel"]
    for name, bands in zip(pmeta["outputs"], out):
        if any(b.device.type != "cuda" for b in bands):
            raise SystemExit(f"shard: P-step output {name} left the card")
        if int32_md5(gather(bands).cpu()) != pmeta["outputs"][name]["md5"]:
            raise SystemExit(f"shard: the 1080p P step's {name} differs "
                             "from the JAX package's")
    if [frame_md5(f) for f in frames] != meta["frame_md5"]:
        raise SystemExit(f"shard: the grouped decode of {SHARD} misses the "
                         "recorded MD5s")
    n_dec = 2 * meta["frames"]
    print(f"shard phase: 1080p P step on {SHARD_BANDS} bands equal to the "
          f"JAX package's 8 outputs ({enc_db} deblock kernel launches); "
          f"{SHARD} decoded in 2 groups of 2 bands, {len(frames)} frames "
          f"equal to the MD5s ({db - enc_db} deblock kernel launches, "
          f"{gop} GOP kernel launches); deblock kernel == plain twin on "
          f"{twins.calls['deblock']} calls, MB grids "
          f"{sorted(twins.shapes['deblock'])}, max_abs_err "
          f"{twins.err['deblock']}", flush=True)
    print(f"shard phase: full search launches {me[0]}, refinement launches "
          f"{me[1]}; full search == plain twin on "
          f"{twins.calls['full_search']} calls, refinement on "
          f"{twins.calls['refine']}, MB grids "
          f"{sorted(twins.shapes['full_search'])}, max_abs_err "
          f"{twins.err['full_search']} / {twins.err['refine']}", flush=True)
    print(f"shard phase: P body kernel launches {enc_pb}; == plain twin on "
          f"{ {n: twins.calls[n] for n in P_KERNELS} } calls, MB grids "
          f"{sorted(twins.shapes['p_residual'])}, max_abs_err "
          f"{ {n: twins.err[n] for n in P_KERNELS} }", flush=True)
    print(f"shard phase: the decode's intra wavefront, deblock parameter "
          f"and half-pel stack launches {dec} ({work.counts['shard_intra']} "
          f"band pictures with an intra MB); == plain twin on "
          f"{ {n: twins.calls[n] for n in DEC_KERNELS} } and "
          f"{twins.decode_halfpel} calls, MB grids "
          f"{ {n: sorted(twins.shapes[n]) for n in DEC_KERNELS} }, "
          f"max_abs_err { {n: twins.err[n] for n in DEC_KERNELS} }",
          flush=True)
    if enc_db != SHARD_BANDS or db - enc_db != n_dec or gop:
        raise SystemExit(f"shard: deblock launches {enc_db} (step) and "
                         f"{db - enc_db} (decode), GOP kernel {gop}; "
                         f"expected {SHARD_BANDS}, {n_dec} and 0")
    if twins.calls["deblock"] != SHARD_BANDS + n_dec or \
            twins.shapes["deblock"] != {(120, 17), (120, 34)}:
        raise SystemExit(f"shard: twin checks {twins.calls} at "
                         f"{twins.shapes} do not cover the path")
    if me != (SHARD_BANDS, SHARD_BANDS) or \
            (twins.calls["full_search"], twins.calls["refine"]) != me or \
            twins.shapes["refine"] != {(120, 17)}:
        raise SystemExit(f"shard: {me[0]} full search and {me[1]} "
                         f"refinement launches, twin checks {twins.calls} "
                         f"at {twins.shapes}; expected {SHARD_BANDS} of "
                         f"each at 120x17 MBs")
    if enc_pb != dict.fromkeys(P_KERNELS, SHARD_BANDS) or \
            any(twins.calls[n] - (twins.decode_halfpel if n == "halfpel"
                                  else 0) != SHARD_BANDS or
                not {(120, 17)} <= twins.shapes[n] for n in P_KERNELS):
        raise SystemExit(f"shard: P body kernel launches {enc_pb}, twin "
                         f"checks {twins.calls} at {twins.shapes}; "
                         f"expected {SHARD_BANDS} of each at 120x17 MBs")
    if dec["deblock_params_dec"] != n_dec or not dec["intra_dec"] or \
            dec["intra_dec"] != work.counts["shard_intra"] or \
            dec["halfpel"] % n_dec or not dec["halfpel"] or \
            pb["halfpel"] != SHARD_BANDS + dec["halfpel"] or \
            (twins.calls["intra_dec"], twins.calls["deblock_params_dec"],
             twins.decode_halfpel) != (dec["intra_dec"], n_dec,
                                       dec["halfpel"]) or \
            (dec["residual_dec"], dec["mc_dec"], dec["ring_write_dec"]) != \
            (n_dec, n_dec, 0) or \
            (twins.calls["residual_dec"], twins.calls["mc_dec"],
             twins.calls["ring_write_dec"]) != (n_dec, n_dec, 0) or \
            any(twins.shapes[n] != {(120, 34)} for n in DEC_KERNELS
                if n != "ring_write_dec"):
        raise SystemExit(f"shard: decode launches {dec}, twin checks "
                         f"{twins.calls} at {twins.shapes}; expected "
                         f"{n_dec} deblock parameter, residual and MC "
                         "launches and no ring write, a half-pel "
                         "stack per ring slot of each band picture, and "
                         f"{work.counts['shard_intra']} intra wavefront "
                         "launches (one per band picture with an intra "
                         "MB), at 120x34 MBs")
    return db, me, twins, planes, pb, \
        {k: dec[k] for k in DEC_KERNELS}


def shard_rates(torch, card, planes):
    """Best and worst of 3 after a warm-up (for the 4-band mesh, the shard
    phase's runs): ms per 1080p P step on 4 bands and on one band, and
    frames/s of the grouped sharded decode and of ``Codec.decode_annexb``
    of the same stream on the card, every decode's MD5s checked."""
    from hartallo_tpu_torch.api import Codec, CodecConfig
    from hartallo_tpu_torch.parallel.shard import Mesh
    pmeta = json.loads((FIXTURES / f"{SHARD_P}.json").read_text())
    stream, meta = load_fixture(SHARD)
    four, one = Mesh(("cuda:0",) * SHARD_BANDS), Mesh(("cuda:0",))
    shard_step(torch, one, planes, pmeta)                      # warm-up
    steps = {}
    for label, mesh in (("4 bands", four), ("1 band", one)):
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            shard_step(torch, mesh, planes, pmeta)
            runs.append((time.perf_counter() - t0) * 1e3)
        steps[label] = runs
    print(f"[{card}] 1080p sharded P step ms best / worst: "
          + "; ".join(f"{k} {min(v):.1f} / {max(v):.1f}"
                      for k, v in steps.items())
          + " (3 runs after a warm-up)", flush=True)
    rates = {"sharded, 2 groups of 2 bands": [], "Codec.decode_annexb": []}
    Codec(CodecConfig()).decode_annexb(stream, tolerant=False)  # warm-up
    for _ in range(3):
        frames, dt = shard_decode(torch, four, stream)
        if [frame_md5(f) for f in frames] != meta["frame_md5"]:
            raise SystemExit("shard: a timed sharded decode differs")
        rates["sharded, 2 groups of 2 bands"].append(len(frames) / dt)
        t0 = time.perf_counter()
        out = Codec(CodecConfig()).decode_annexb(stream, tolerant=False)
        torch.cuda.synchronize()
        rates["Codec.decode_annexb"].append(
            len(out) / (time.perf_counter() - t0))
        if [frame_md5(r.frame) for r in out] != meta["frame_md5"]:
            raise SystemExit("shard: the plain decode differs")
    print(f"[{card}] {SHARD} decode fps best / worst: "
          + "; ".join(f"{k} {max(v):.2f} / {min(v):.2f}"
                      for k, v in rates.items())
          + " (3 runs after a warm-up)", flush=True)


def encode_rates(torch, name, runs=3):
    """Frames per second of ``runs`` encodes of a fixture's clip, each
    stream equal to the fixture (no warm-up here)."""
    rates = []
    for _ in range(runs):
        stream, dt, meta = encode_clip(torch, name)
        if stream != load_fixture(name)[0]:
            raise SystemExit(f"{name}: the encode differs from the fixture")
        rates.append(meta["frames"] / dt)
    return rates


def decode_rates(torch, name, runs=3):
    """Frames per second of ``runs`` decodes of a fixture after a warm-up
    decode, every frame's MD5 checked."""
    decode_fixture(torch, name)                                # warm-up
    return [nf / dt for _, dt, nf in (decode_fixture(torch, name)
                                      for _ in range(runs))]


def encode_fps(torch, name, card):
    """Best and worst of 3 encodes; the encode phase's run was the
    warm-up."""
    runs = encode_rates(torch, name)
    print(f"[{card}] {name} port encode fps best {max(runs):.2f} worst "
          f"{min(runs):.2f} (3 runs after a warm-up)", flush=True)


def fps(torch, name, card):
    runs = decode_rates(torch, name)
    print(f"[{card}] {name} port decode fps best {max(runs):.2f} worst "
          f"{min(runs):.2f} (3 runs after a warm-up)", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    started = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    sys.path[:0] = [str(REPO), str(REPO / "tools")]
    from hartallo_tpu_torch import kernels, native
    t0 = time.perf_counter()
    lib = kernels.build()
    print(f"built {lib.relative_to(REPO)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in kernels.BUILD_LOG.splitlines():
        if line.startswith("== ") or "Compiling entry" in line or \
                "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)
    if not native.available():
        raise SystemExit("the port's native slice parser and packer did "
                         "not build or load: the timed path would run the "
                         "pure-Python fallback")
    print(f"native library {pathlib.Path(native._SO).relative_to(REPO)} "
          "loaded", flush=True)
    from hartallo_tpu_torch.encode.intra_encode_fast import THREADS
    attrs = (ctypes.c_int * 6)()
    rc = kernels.load().hl_intra_encode_attributes(attrs)
    if rc != 0:
        raise SystemExit(f"intra kernel attributes: CUDA error {rc} "
                         f"({kernels.error_string(rc)})")
    print(f"intra kernel: blocks of {THREADS} threads, one per MB row "
          f"(a cooperative grid of gh blocks: 9 QCIF, 18 CIF, 45 720p, 68 "
          f"1080p; at most {attrs[5]} on this card), {attrs[0]} bytes of "
          f"dynamic shared memory, {attrs[1]} registers, {attrs[2]} bytes "
          f"of local (spill) memory per thread, {attrs[3]} bytes of static "
          f"shared memory, at most {attrs[4]} threads a block", flush=True)
    me_attrs = (ctypes.c_int * 14)()
    rc = kernels.load().hl_me_attributes(me_attrs)
    if rc != 0:
        raise SystemExit(f"ME kernel attributes: CUDA error {rc} "
                         f"({kernels.error_string(rc)})")
    for what, a in (("full search", me_attrs[:7]),
                    ("refinement", me_attrs[7:])):
        print(f"ME kernel {what}: {a[0]} registers, {a[1]} bytes of local "
              f"(spill) memory per thread, {a[2]} bytes of static and "
              f"{a[3]} of dynamic shared memory, blocks of {a[4]} threads, "
              f"a grid of {a[5]} x {a[6]} blocks at 1080p", flush=True)
    p_attrs = (ctypes.c_int * 24)()
    rc = kernels.load().hl_p_encode_attributes(p_attrs)
    if rc != 0:
        raise SystemExit(f"P body kernel attributes: CUDA error {rc} "
                         f"({kernels.error_string(rc)})")
    for i, name in enumerate(P_KERNELS.values()):
        a = p_attrs[6 * i:6 * i + 6]
        print(f"P body kernel {name}: {a[0]} registers, {a[1]} bytes of "
              f"local (spill) memory per thread, {a[2]} bytes of static and "
              f"{a[3]} of dynamic shared memory, blocks of {a[4]} threads, "
              f"{a[5]} blocks ({a[5] * a[4] // 32} warps) resident an SM",
              flush=True)
    simd = sass_simd(lib, "k_full_search")
    print(f"full search kernel SASS: {simd}", flush=True)
    if simd is not None and not any(simd.values()):
        raise SystemExit("the full search kernel's SASS has no byte-SIMD "
                         "instruction (VABSDIFF4 or IDP.4A)")
    max_err, ms, plain_ms, bound_ms, bound_by = kernel_phase(torch, card)
    db_err, (db_ms, db_plain_ms, db_bound_ms, db_bound_by) = \
        deblock_phase(torch, card)
    in_err, (in_ms, in_plain_ms, in_bound_ms, in_bound_by) = \
        intra_phase(torch, card)
    me_err, me_times = me_phase(torch, card)
    p_err, p_times = p_phase(torch, card)
    dec_err, dec_times = dec_kernels_phase(torch, card)
    mc_err, mc_times = mc_dec_phase(torch, card)
    upload_phase(torch, card)
    launches = slice_phase(torch)
    scan_twins, scan_launches = scan_phase(torch)
    gen_twins, gen_launches = general_phase(torch)
    db_launches, in_launches, fs_launches, rf_launches, pb_launches = \
        encode_phase(torch)
    p_picture_kernels(torch, card)
    t_svc = time.perf_counter()
    svc_launches, svc_db, svc_in, svc_me, svc_stream, clips, twins, \
        svc_pb, svc_dec = svc_phase(torch)
    ilp_twins, ilp_mc, ilp_hp = ilp_phase(torch)
    svc_s = time.perf_counter() - t_svc
    for name in ENCODE_MAIN:
        encode_fps(torch, name, card)
    for name in DECODE_MAIN:
        fps(torch, name, card)
    t_svc = time.perf_counter()
    svc_fps(torch, card, svc_stream, clips)
    svc_s += time.perf_counter() - t_svc
    t_shard = time.perf_counter()
    shard_db, shard_me, shard_twins, planes, shard_pb, shard_dec = \
        shard_phase(torch)
    shard_rates(torch, card, planes)
    shard_s = time.perf_counter() - t_shard
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - started:.1f} s (the SVC phase and its "
          f"rates {svc_s:.1f} s, the shard phase and its rates "
          f"{shard_s:.1f} s)", flush=True)
    dec_err, dec_times = {**dec_err, **mc_err}, {**dec_times, **mc_times}
    ilp = {"mc_dec": ilp_mc, "halfpel": ilp_hp}
    print(json.dumps({"kernels": [
        {"name": "decode_gop_fast", "route": "cuda",
         "source": "hartallo_tpu_torch/csrc/d_gop.cu",
         "replaces": "hartallo_tpu/decode/d_gop_pallas.py:1048",
         "launches": launches + svc_launches,
         "launches_by_path": {"decode": launches, "svc": svc_launches},
         "max_abs_err": max(max_err, twins.err["gop"]),
         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
         "bound_by": bound_by, "library_ms": None},
        {"name": "deblock_frame_fast", "route": "cuda",
         "source": "hartallo_tpu_torch/csrc/deblock.cu",
         "replaces": "hartallo_tpu/ops/deblock_pallas.py:349",
         "launches": db_launches + scan_launches["deblock"] +
         gen_launches["deblock"] + svc_db + shard_db,
         "launches_by_path": {"encode": db_launches,
                              "scan": scan_launches["deblock"],
                              "general": gen_launches["deblock"],
                              "svc": svc_db, "shard": shard_db},
         "max_abs_err": max(db_err, scan_twins.err["deblock"],
                            gen_twins.err["deblock"], twins.err["deblock"],
                            shard_twins.err["deblock"]),
         "ms": db_ms, "plain_ms": db_plain_ms, "bound_ms": db_bound_ms,
         "bound_by": db_bound_by, "library_ms": None},
        {"name": "intra_encode_frame_fast", "route": "cuda",
         "source": "hartallo_tpu_torch/csrc/intra_encode.cu",
         "replaces": "hartallo_tpu/encode/intra_encode.py:46 "
                     "intra_encode_frame (XLA, in e_device.i_frame_fused / "
                     "p_gop_fused)",
         "launches": in_launches + svc_in,
         "launches_by_path": {"encode": in_launches, "svc": svc_in},
         "max_abs_err": max(in_err, twins.err["intra"]),
         "ms": in_ms, "plain_ms": in_plain_ms, "bound_ms": in_bound_ms,
         "bound_by": in_bound_by, "library_ms": None},
        *({"name": name, "route": "cuda",
           "source": "hartallo_tpu_torch/csrc/me_search.cu",
           "replaces": replaces,
           "launches": enc + svc + shard,
           "launches_by_path": {"encode": enc, "svc": svc, "shard": shard},
           "max_abs_err": max(me_err[key], twins.err[key],
                              shard_twins.err[key]),
           "ms": me_times[key][0], "plain_ms": me_times[key][1],
           "bound_ms": me_times[key][2], "bound_by": me_times[key][3],
           "library_ms": None}
          for name, key, replaces, enc, svc, shard in (
              ("full_search_int_fast", "full_search",
               "hartallo_tpu/encode/me.py:36 full_search_int (XLA, in "
               "p_device.p_frame_device)", fs_launches, svc_me[0],
               shard_me[0]),
              ("refine_subpel_rounds_fast", "refine",
               "hartallo_tpu/encode/me.py:124 refine_subpel (XLA, two "
               "rounds in p_device.p_frame_device)", rf_launches,
               svc_me[1], shard_me[1]))),
        *({"name": name, "route": "cuda",
           "source": "hartallo_tpu_torch/csrc/p_encode.cu",
           "replaces": replaces,
           "launches": pb_launches[key] + scan_launches.get(key, 0) +
           svc_pb[key] + shard_pb[key] + ilp.get(key, 0),
           "launches_by_path": {"encode": pb_launches[key],
                                "scan": scan_launches.get(key, 0),
                                "svc": svc_pb[key],
                                "shard": shard_pb[key],
                                "ilp": ilp.get(key, 0)},
           "max_abs_err": max(p_err[key], scan_twins.err[key],
                              twins.err[key], shard_twins.err[key],
                              ilp_twins.err[key]),
           "ms": p_times[key][0], "plain_ms": p_times[key][1],
           "bound_ms": p_times[key][2], "bound_by": p_times[key][3],
           "library_ms": None}
          for name, key, replaces in (
              ("partition_decide_fast", "part_decide",
               "hartallo_tpu/encode/p_device.py:79 the partition decision "
               "(XLA, in e_device.p_gop_fused)"),
              ("halfpel_planes_fast", "halfpel",
               "hartallo_tpu/ops/wide.py:49 halfpel_planes (XLA, in "
               "p_device.p_frame_device)"),
              ("p_residual_fast", "p_residual",
               "hartallo_tpu/encode/p_device.py:114 MC, residual and recon "
               "(decode/inter_recon.py:31, ops/transform.py) and "
               "e_device.py:178 the intra-in-P estimate (XLA, in "
               "e_device.p_gop_fused)"),
              ("deblock_params_fast", "deblock_params",
               "hartallo_tpu/ops/deblock.py:44 compute_bs and "
               "ops/deblock_pallas.py:274 _edge_params (in "
               "e_device.deblock_recon_device)"))),
        *({"name": name, "route": "cuda",
           "source": f"hartallo_tpu_torch/csrc/{source}",
           "replaces": replaces,
           "launches": scan_launches[key] + gen_launches[key] +
           svc_dec[key] + shard_dec[key] + ilp.get(key, 0),
           "launches_by_path": {"scan": scan_launches[key],
                                "general": gen_launches[key],
                                "svc": svc_dec[key],
                                "shard": shard_dec[key],
                                "ilp": ilp.get(key, 0)},
           "max_abs_err": max(dec_err[key], scan_twins.err[key],
                              gen_twins.err[key], twins.err[key],
                              shard_twins.err[key], ilp_twins.err[key]),
           "ms": dec_times[key][0], "plain_ms": dec_times[key][1],
           "bound_ms": dec_times[key][2], "bound_by": dec_times[key][3],
           "library_ms": None}
          for name, key, source, replaces in (
              ("intra_reconstruct_fast", "intra_dec", "intra_decode.cu",
               "hartallo_tpu/decode/intra_recon.py:233 intra_reconstruct "
               "(XLA, in d_gop.py:193, decoder.py:835, shard.py:248)"),
              ("deblock_params_dec_fast", "deblock_params_dec",
               "deblock.cu",
               "hartallo_tpu/ops/deblock_pallas.py:274 _edge_params of "
               "deblock_frame_pl, with ops/wide.py:310 compute_bs_grids "
               "(in d_gop.prepare_pictures and the general route)"),
              ("residual_planes_fast", "residual_dec", "mc_decode.cu",
               "hartallo_tpu/decode/d_gop.py:120-127 (XLA: ops/wide.py:259 "
               "residual_planes_wide)"),
              ("mc_recon_fast", "mc_dec", "mc_decode.cu",
               "hartallo_tpu/decode/d_gop.py:183-191 (XLA: ops/wide.py:117 "
               "mc_luma_plane, :161 mc_chroma_plane, the residual add, "
               "mask and pad)"),
              ("ring_write_fast", "ring_write_dec", "mc_decode.cu",
               "hartallo_tpu/decode/d_gop.py:208-229 (XLA: the ring write "
               "and output, ops/wide.py:49 halfpel_planes)")))]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
