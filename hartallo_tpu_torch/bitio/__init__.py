from hartallo_tpu_torch.bitio.reader import BitReader
from hartallo_tpu_torch.bitio.writer import BitWriter
from hartallo_tpu_torch.bitio.annexb import (
    find_nal_units,
    strip_emulation_prevention,
    insert_emulation_prevention,
)

__all__ = [
    "BitReader", "BitWriter", "find_nal_units",
    "strip_emulation_prevention", "insert_emulation_prevention",
]
