"""Whole-decode tests of the PyTorch port against the JAX package.

- A 64x48x5 stream encoded by ``hartallo_tpu`` decodes to the same bytes
  through both packages.
- The fixtures in tests/data/port (written by tools/make_port_fixtures.py
  from ``hartallo_tpu``) decode to the recorded per-frame MD5s.
- A port encode and decode run without jax, and without any module of
  ``hartallo_tpu``, in ``sys.modules``.
- The 720p and 1080p IDR pictures, which the JAX package's Pallas kernel
  refuses, are eligible for the port's GOP kernel.

Tolerance: exact equality, since this is an integer codec.
"""
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from _torch_port import cuda_device, encode_clip, load_fixture  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent


def _port_decode(stream, device="cpu"):
    from hartallo_tpu_torch.api import Codec, CodecConfig
    codec = Codec(CodecConfig(), device=device)
    return codec.decode_annexb(stream, tolerant=False), codec.decoder.stats


def test_port_decode_equals_jax_decode():
    from hartallo_tpu.api import Codec, CodecConfig
    stream = encode_clip()
    want = Codec(CodecConfig()).decode_annexb(stream, tolerant=False)
    got, stats = _port_decode(stream)
    assert len(got) == len(want) == 5
    # every picture (the I picture and intra-in-P included) takes the
    # kernel route, here its plain twin on the CPU
    assert stats == {"kernel_pictures": 5, "scan_pictures": 0,
                     "general_pictures": 0}
    for i, (a, b) in enumerate(zip(got, want)):
        assert (a.width, a.height, a.poc) == (b.width, b.height, b.poc)
        np.testing.assert_array_equal(a.frame, b.frame, err_msg=f"frame {i}")


# the bench clip, then the stream classes of the batched path (slices,
# FMO, no deblocking across slice edges, non-reference pictures)
SMALL = ["qcif_8", "cif_16", "qcif_6_slices3", "qcif_6_fmo1",
         "qcif_6_idc2", "qcif_6_tl2"]


@pytest.mark.parametrize("name", SMALL)
def test_fixture_decodes_to_recorded_md5(name):
    from hartallo_tpu.util.checks import plane_md5
    stream, meta = load_fixture(name)
    out, stats = _port_decode(stream)
    assert [plane_md5(r.frame) for r in out] == meta["frame_md5"]
    assert stats == {"kernel_pictures": meta["frames"], "scan_pictures": 0,
                     "general_pictures": 0}


def test_scan_route_decodes_fixture(monkeypatch):
    """With the kernel refusing every picture, the GOP scan decodes the
    whole stream to the same bytes."""
    from hartallo_tpu.util.checks import plane_md5
    from hartallo_tpu_torch.decode import d_pool
    monkeypatch.setattr(d_pool, "eligible", lambda sd, wp: "refused")
    stream, meta = load_fixture("qcif_6_slices3")
    out, stats = _port_decode(stream)
    assert [plane_md5(r.frame) for r in out] == meta["frame_md5"]
    assert stats == {"kernel_pictures": 0, "scan_pictures": meta["frames"],
                     "general_pictures": 0}


def test_port_decode_imports_no_jax():
    code = (
        "import sys\n"
        "from bench import make_clip\n"
        "from hartallo_tpu_torch.api import Codec, CodecConfig\n"
        "s = open('tests/data/port/qcif_6.264', 'rb').read()\n"
        "enc = Codec(CodecConfig(width=176, height=144, qp=30, gop_size=6,\n"
        "                        deblock=True, me_range=12), device='cpu')\n"
        "res = enc.encode_frames(make_clip(176, 144, 6))\n"
        "assert b''.join(r.headers + r.data for r in res) == s\n"
        "out = Codec(CodecConfig(), device='cpu').decode_annexb(s)\n"
        "assert len(out) == 6, len(out)\n"
        "import hartallo_tpu_torch.cli, hartallo_tpu_torch.engine\n"
        "from hartallo_tpu_torch.parallel.shard import Mesh, "
        "decode_gops_grouped\n"
        "g = open('tests/data/port/shard_96x64_8.264', 'rb').read()\n"
        "f = decode_gops_grouped(Mesh(('cpu',) * 8), g, groups=2)\n"
        "import json\n"
        "from hartallo_tpu_torch.util.checks import plane_md5\n"
        "m = json.load(open('tests/data/port/shard_96x64_8.json'))\n"
        "assert [plane_md5(x) for x in f] == m['frame_md5']\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', "
        "'hartallo_tpu') or m.startswith(('jax.', 'jaxlib.', "
        "'hartallo_tpu.'))]\n"
        "assert not bad, bad\n"
        "from hartallo_tpu_torch import native\n"
        "assert native.available()\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("name", ["qcif_8", "svc_il_4"])
def test_decoder_freed_without_cycle_collector(name):
    """A finished decode leaves no reference cycle through the decoder:
    once the caller drops the codec, the decoder (and its device rings)
    go at once, not when the cyclic garbage collector next runs."""
    import gc
    import weakref

    from hartallo_tpu_torch.api import Codec, CodecConfig
    stream, meta = load_fixture(name)

    def decode():
        codec = Codec(CodecConfig(), device="cpu")
        out = codec.decode_annexb(stream, tolerant=False)
        assert len(out) == len(meta["frame_md5"])
        return weakref.ref(codec.decoder)

    decode()                     # first use: imports, cached builds
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        assert decode()() is None
    finally:
        if enabled:
            gc.enable()


def test_unported_paths_raise():
    """What neither package decodes, an MVC slice extension (NAL type 20
    with svc_extension_flag 0), raises NotImplementedError when the
    caller is not tolerant; in tolerant mode it is skipped
    (tests/test_torch_general_path.py).  SVC NAL units and SVC
    configurations are ported: a subset SPS alone decodes to nothing."""
    from hartallo_tpu_torch.api import Codec, CodecConfig
    codec = Codec(CodecConfig(), device="cpu")
    with pytest.raises(NotImplementedError, match="MVC"):
        codec.decode_annexb(b"\x00\x00\x00\x01\x14\x40\x11\x22\x80",
                            tolerant=False)
    assert Codec(CodecConfig(), device="cpu").decode_annexb(
        b"\x00\x00\x00\x01\x6f\x53\x00\x1e\xab", tolerant=True) == []


@pytest.mark.parametrize("name", ["720p_8", "1080p_8"])
def test_hd_idr_picture_is_eligible(name):
    """Parse only: every picture of the 720p and 1080p fixtures, the IDR
    picture (3,600 and 8,160 intra MBs) included, gets a kernel payload."""
    from _torch_port import queued_jobs
    from hartallo_tpu.decode import d_pool as J
    stream, meta = load_fixture(name)
    jobs, (gw, gh, _, _) = queued_jobs(stream)
    assert len(jobs) == meta["frames"]
    assert all(j.fast is not None for j in jobs)
    assert jobs[0].fast.ilist.shape[0] == gw * gh > J.nimax(gw, gh)


def test_weighted_fixture_is_the_rewrite():
    """qcif_6_wp is tests/_torch_port.weighted_rewrite of qcif_6, and the
    port decodes it to the JAX package's MD5s: 1 kernel, 5 scan pictures."""
    from _torch_port import weighted_rewrite
    from hartallo_tpu.util.checks import plane_md5
    stream, meta = load_fixture("qcif_6_wp")
    assert weighted_rewrite(load_fixture("qcif_6")[0]) == stream
    out, stats = _port_decode(stream)
    assert [plane_md5(r.frame) for r in out] == meta["frame_md5"]
    assert stats == {"kernel_pictures": 1, "scan_pictures": 5,
                     "general_pictures": 0}


# every fixture on the card through Codec's default device: all pictures
# through the GOP kernel, except the weighted P pictures of qcif_6_wp
@pytest.mark.cuda
@pytest.mark.parametrize("name", SMALL + ["720p_8", "1080p_8", "qcif_6_wp"])
def test_cuda_decode_matches_recorded_md5(cuda_device, name):
    from hartallo_tpu.util.checks import plane_md5
    from hartallo_tpu_torch.api import Codec, CodecConfig
    stream, meta = load_fixture(name)
    codec = Codec(CodecConfig())
    out, stats = codec.decode_annexb(stream, tolerant=False), \
        codec.decoder.stats
    assert codec.decoder.device.type == "cuda"
    assert [plane_md5(r.frame) for r in out] == meta["frame_md5"]
    scan = 5 if name == "qcif_6_wp" else 0
    assert stats == {"kernel_pictures": meta["frames"] - scan,
                     "scan_pictures": scan, "general_pictures": 0}
