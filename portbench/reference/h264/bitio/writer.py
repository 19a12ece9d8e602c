"""Host-side bitstream writer: fixed-width writes + Exp-Golomb (ue/se/te).

Mirror of :mod:`hartallo_tpu.bitio.reader`; reference semantics:
``hl_codec_264_bits.h`` ``write_u1/u/ue/se/te`` + trailing-bit helpers in
``hl_codec_264_rbsp.c``.
"""
from __future__ import annotations


class BitWriter:
    __slots__ = ("_acc", "_accbits", "_out")

    def __init__(self) -> None:
        self._acc = 0        # bit accumulator (MSB-first semantics)
        self._accbits = 0    # number of valid bits in _acc
        self._out = bytearray()

    def u(self, value: int, n: int) -> None:
        """Write n bits of value, MSB first."""
        if n == 0:
            return
        if value < 0 or value >> n:
            raise ValueError(f"value {value} does not fit in {n} bits")
        self._acc = (self._acc << n) | value
        self._accbits += n
        while self._accbits >= 8:
            self._accbits -= 8
            self._out.append((self._acc >> self._accbits) & 0xFF)
        self._acc &= (1 << self._accbits) - 1

    def u1(self, bit: int) -> None:
        self.u(bit & 1, 1)

    def ue(self, value: int) -> None:
        if value < 0:
            raise ValueError("ue() needs non-negative value")
        code = value + 1
        n = code.bit_length()
        self.u(0, n - 1)
        self.u(code, n)

    def se(self, value: int) -> None:
        # spec 9.1.1: codeNum = 2|v| - 1 for v > 0, 2|v| for v <= 0.
        self.ue(2 * value - 1 if value > 0 else -2 * value)

    def te(self, value: int, value_range: int) -> None:
        if value_range == 1:
            self.u1(1 - value)
        else:
            self.ue(value)

    # -- state ------------------------------------------------------------
    @property
    def bitpos(self) -> int:
        return len(self._out) * 8 + self._accbits

    def byte_aligned(self) -> bool:
        return self._accbits == 0

    def write_rbsp_trailing_bits(self) -> None:
        self.u1(1)
        while not self.byte_aligned():
            self.u1(0)

    def align_zero(self) -> None:
        while not self.byte_aligned():
            self.u1(0)

    def partial(self):
        """Return (bytes incl. the in-progress byte, bit position) — used
        to hand off to the native packer which continues in-place."""
        data = bytes(self._out)
        if self._accbits:
            data += bytes([(self._acc << (8 - self._accbits)) & 0xFF])
        return data, self.bitpos

    def getvalue(self) -> bytes:
        """Return the written bytes (must be byte-aligned)."""
        if self._accbits:
            raise ValueError("bitstream not byte-aligned")
        return bytes(self._out)
