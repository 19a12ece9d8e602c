from portbench.reference.h264.bitio.reader import BitReader
from portbench.reference.h264.bitio.writer import BitWriter
from portbench.reference.h264.bitio.annexb import (
    find_nal_units,
    strip_emulation_prevention,
    insert_emulation_prevention,
)

__all__ = [
    "BitReader", "BitWriter", "find_nal_units",
    "strip_emulation_prevention", "insert_emulation_prevention",
]
