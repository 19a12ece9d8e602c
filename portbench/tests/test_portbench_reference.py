"""The frozen reference decodes the port's recorded fixtures to their
MD5s, and its control (the precision a faster program might drop) comes
out different from it."""
import hashlib
import json

import pytest

from portbench import harness
from portbench.clip import make_segment
from portbench.reference import check
from portbench.reference.decode import decode_picture, split_stream

FIXTURES = harness.REPO / "tests" / "data" / "port"


def _fixture(name):
    return ((FIXTURES / f"{name}.264").read_bytes(),
            json.loads((FIXTURES / f"{name}.json").read_text()))


def _decode_chain(data, control=False):
    sps, pps, pictures = split_stream(data)
    ref, out = None, []
    for p in pictures:
        f = decode_picture(p, sps, pps, None if p.idr else ref,
                           control=control)
        out.append(f)
        ref = f
    return out


@pytest.mark.parametrize("name", ["qcif_6", "qcif_8", "cif_16"])
def test_reference_decodes_fixture_md5s(name):
    data, meta = _fixture(name)
    frames = _decode_chain(data)
    assert [hashlib.md5(f.tobytes()).hexdigest() for f in frames] == \
        meta["frame_md5"]


@pytest.mark.parametrize("seed", [3, 2**31 + 5, 977])
def test_control_fails_on_the_benchmark_clip(seed):
    """At QCIF on the seed's clip, encoded by the program as a decode
    cell's set-up encodes it: the reference decodes it, and the control
    (the half-pel j from 8-bit b samples) differs from the reference by
    more than the limit 0 on some P picture."""
    from hartallo_tpu_torch.api import Codec, CodecConfig
    frames = make_segment(seed, 176, 144, 4, device="cpu")
    enc = Codec(CodecConfig(width=176, height=144, gop_size=4, qp=30,
                            me_range=16, deblock=True), device="cpu")
    stream = b"".join(r.headers + r.data
                      for r in enc.encode_frames(frames, 176, 144))
    want = _decode_chain(stream)
    sps, pps, pictures = split_stream(stream)
    worst = max(check.max_abs_diff(
        decode_picture(pictures[k], sps, pps, want[k - 1], control=True),
        want[k]) for k in range(1, len(pictures)))
    assert worst > 0
