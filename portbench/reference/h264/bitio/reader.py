"""Host-side bitstream reader: fixed-width reads + Exp-Golomb (ue/se/te).

Semantics follow spec 9.1 (parsing of Exp-Golomb codes) and the reference's
inline cursor (``hl_codec_264_bits.h``: ``read_u1/u/ue/se/te``,
``more_rbsp_data``), re-expressed as a window-cached reader over an RBSP byte
buffer (emulation-prevention bytes already stripped; see
``hartallo_tpu.bitio.annexb``).
"""
from __future__ import annotations


#: Reads may run this many bits past the RBSP end, returning zero bits.
#: The reference decoder's NAL buffer is zero-padded
#: (``hl_codec_264.c:193-205``) and its cursor reads the padding silently,
#: which matters because the reference *encoder* under-writes the final
#: CAVLC level escape on dense content (stale entries in its level table,
#: ``hl_codec_264_cavlc.c:76``): a bit-exact decode of such streams must
#: consume the same zero tail instead of raising at the payload boundary.
PAD_BITS = 256


class BitReader:
    __slots__ = ("data", "nbits", "pos")

    def __init__(self, data: bytes):
        # zero tail so reads can run (bounded) past the payload; `nbits`
        # stays the true payload length for more_rbsp_data/bits_left.
        self.nbits = len(data) * 8
        self.data = bytes(data) + b"\x00" * (PAD_BITS // 8)
        self.pos = 0  # absolute bit position

    # -- fixed-width ------------------------------------------------------
    def u(self, n: int) -> int:
        """Read n bits MSB-first as an unsigned integer."""
        if n == 0:
            return 0
        pos = self.pos
        end = pos + n
        if end > self.nbits + PAD_BITS:
            raise EOFError("bitstream overrun")
        first = pos >> 3
        last = (end + 7) >> 3
        chunk = int.from_bytes(self.data[first:last], "big")
        shift = (last << 3) - end
        self.pos = end
        return (chunk >> shift) & ((1 << n) - 1)

    def u1(self) -> int:
        return self.u(1)

    # -- Exp-Golomb -------------------------------------------------------
    def ue(self) -> int:
        """Unsigned Exp-Golomb (spec 9.1), with the reference decoder's
        16-bit-window semantics: leadingZeroBits = clz16(show(16)), capped
        at 16 (``hl_codec_264_bits.h:697-705``, non-legacy path).  An
        all-zero window therefore decodes deterministically instead of
        scanning onward — required for bit-exact decode of streams the
        reference encoder under-writes (see PAD_BITS)."""
        w = self.peek(16)
        if w == 0:
            zeros = 16
        else:
            zeros = 16 - w.bit_length()
        if zeros == 0:
            self.pos += 1
            return 0
        self.skip(zeros + 1)
        info = self.u(zeros)
        return (1 << zeros) - 1 + info

    def se(self) -> int:
        """Signed Exp-Golomb (spec 9.1.1): k -> (-1)^(k+1) * ceil(k/2)."""
        k = self.ue()
        return (k + 1) >> 1 if (k & 1) else -(k >> 1)

    def te(self, value_range: int) -> int:
        """Truncated Exp-Golomb (spec 9.1.1)."""
        if value_range == 1:
            return 1 - self.u1()
        return self.ue()

    # -- helpers ----------------------------------------------------------
    def _peek(self, pos: int, n: int) -> int:
        first = pos >> 3
        end = pos + n
        last = (end + 7) >> 3
        chunk = int.from_bytes(self.data[first:last], "big")
        shift = (last << 3) - end
        return (chunk >> shift) & ((1 << n) - 1)

    def peek(self, n: int) -> int:
        """Peek n bits without consuming (short reads padded with 0s)."""
        avail = self.nbits + PAD_BITS - self.pos
        if avail >= n:
            return self._peek(self.pos, n)
        if avail <= 0:
            return 0
        return self._peek(self.pos, avail) << (n - avail)

    def skip(self, n: int) -> None:
        self.pos += n
        if self.pos > self.nbits + PAD_BITS:
            raise EOFError("skip past end")

    def byte_aligned(self) -> bool:
        return (self.pos & 7) == 0

    def bits_left(self) -> int:
        return self.nbits - self.pos

    def more_rbsp_data(self) -> bool:
        """Spec 7.2: true iff bits remain beyond the rbsp_stop_one_bit
        (the last 1 bit in the stream, followed only by zero bits)."""
        idx = self.pos >> 3
        used = self.pos & 7
        nbytes = self.nbits >> 3  # true payload, excluding the zero pad
        width = (nbytes - idx) * 8 - used
        if width <= 0:
            return False
        tail = int.from_bytes(self.data[idx:nbytes], "big")
        if used:
            tail &= (1 << width) - 1
        if tail == 0:
            return False  # malformed (no stop bit), nothing left to parse
        # The stop bit is the last set bit. No data remains iff the very
        # next bit is that stop bit, i.e. the tail is exactly 1 followed by
        # zeros: tail == 1 << (width - 1).
        return tail != (1 << (width - 1))

    def read_rbsp_trailing_bits(self) -> None:
        one = self.u1()
        if one != 1:
            raise ValueError("rbsp_stop_one_bit != 1")
        while not self.byte_aligned():
            if self.u1() != 0:
                raise ValueError("rbsp_alignment_zero_bit != 0")
