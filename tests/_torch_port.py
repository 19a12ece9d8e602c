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
