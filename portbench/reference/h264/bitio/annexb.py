"""Annex-B byte-stream utilities: NAL unit scanning and emulation prevention.

Reference semantics: start-code scanner ``hl_parser_264.c:13-45``
(find_bounds), EPB strip ``hl_codec_264.c:207-217``, EPB insert
``hl_codec_264_rbsp.c`` (avc_escape).  Implemented with numpy vector scans
instead of a byte loop.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def find_nal_units(data: bytes) -> List[Tuple[int, int]]:
    """Return (start, end) byte offsets of each NAL unit payload in an
    Annex-B stream (offsets exclude the start code; end is exclusive)."""
    buf = np.frombuffer(data, dtype=np.uint8)
    n = buf.size
    if n < 4:
        return []
    # positions i where buf[i:i+3] == 00 00 01
    z = buf == 0
    sc3 = z[:-2] & z[1:-1] & (buf[2:] == 1)
    starts3 = np.nonzero(sc3)[0]
    if starts3.size == 0:
        return []
    # Collapse 4-byte start codes (00 00 00 01): a 3-byte match whose
    # predecessor byte is 0 and which is itself preceded by a match at i-1
    # still yields the same payload start (i+3).
    payload_starts = starts3 + 3
    # Drop overlapping matches (00 00 00 01 produces matches at i and i+1).
    keep = np.ones(starts3.size, dtype=bool)
    keep[1:] = np.diff(starts3) > 1
    payload_starts = payload_starts[keep]
    starts3 = starts3[keep]
    units = []
    for k in range(payload_starts.size):
        s = int(payload_starts[k])
        if k + 1 < starts3.size:
            e = int(starts3[k + 1])
            # Strip the zero that belongs to a following 4-byte start code
            # and any trailing_zero_8bits.
            while e > s and buf[e - 1] == 0:
                e -= 1
        else:
            e = n
            while e > s and buf[e - 1] == 0:
                e -= 1
        if e > s:
            units.append((s, e))
    return units


def strip_emulation_prevention(nal: bytes) -> bytes:
    """Remove emulation_prevention_three_byte: 00 00 03 -> 00 00."""
    buf = np.frombuffer(nal, dtype=np.uint8)
    n = buf.size
    if n < 3:
        return nal
    z = buf == 0
    is_epb = np.zeros(n, dtype=bool)
    # candidate positions of the 0x03 byte
    cand = np.nonzero(z[:-2] & z[1:-1] & (buf[2:] == 3))[0] + 2
    # EPBs cannot overlap: 00 00 03 00 00 03 — after removing the first 03,
    # the bytes are 00 00 00 00 03?? No: the *encoder* escapes each 00 00
    # window; consecutive windows share zeros only through the escaped
    # output, and a previous EPB byte (03) breaks the zero run. A scan is
    # needed only when candidates are < 3 bytes apart.
    prev = -3
    for c in cand:
        if c - prev >= 3:
            is_epb[c] = True
            prev = c
        else:
            # zeros feeding this candidate included an EPB byte -> not an EPB
            pass
    if not is_epb.any():
        return nal
    return buf[~is_epb].tobytes()


def insert_emulation_prevention(rbsp: bytes) -> bytes:
    """Insert emulation_prevention_three_byte so no 00 00 0x (x<=3) pattern
    appears in the NAL payload (spec 7.4.1.1)."""
    # fast path: no 00 00 0x candidates at all (the common case)
    buf = np.frombuffer(rbsp, dtype=np.uint8)
    if buf.size >= 3:
        z = buf == 0
        if not (z[:-2] & z[1:-1] & (buf[2:] <= 3)).any():
            return rbsp
    elif buf.size < 3:
        return rbsp
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)
