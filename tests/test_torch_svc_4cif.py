"""The three-layer QCIF/CIF/4CIF SVC fixture ``svc3_4cif_8`` (dyadic
spatial layers, two temporal layers, base-mode EP pictures and residual
prediction on) through the PyTorch port on the CPU: the stream
``chip_smoke.py`` encodes and decodes on the card.

- The port's decode gives every output picture's recorded MD5 and DQId,
  and so do its ``dqid_max=0`` and ``tid_max=0`` decodes.
- The port's encode of the three clips gives the fixture's bytes.

Tolerance: exact equality of bytes and MD5s.
"""
import pytest

from _torch_port import load_fixture, one_torch_thread  # noqa: F401
from test_torch_svc import check_decode, check_windows, port_encode

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NAME = "svc3_4cif_8"


def test_svc3_decodes_to_recorded_md5():
    stats = check_decode(NAME)
    meta = load_fixture(NAME)[1]
    assert sorted(set(meta["frame_dqid"])) == [0, 16, 32]
    assert stats["kernel_pictures"] > 0


def test_svc3_windows_decode_to_recorded_md5():
    check_windows(NAME)


def test_svc3_encodes_byte_for_byte():
    assert port_encode(NAME) == load_fixture(NAME)[0]
