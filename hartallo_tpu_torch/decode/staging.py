"""The GOP scan's per-MB words on their way to the card.

The decoder packs each scan picture's rows (``d_fused.pack_slice_rows``,
(gh*gw, WORDS) int16) straight into a row of a host buffer, the row of
its place in the layer's queue, and a batch's rows reach the decoder's
device with one asynchronous copy; the kernels then read them as int16
(``mc_decode_fast.residual_planes_fast``,
``ops/deblock_fast.deblock_params_dec_fast``).  On a CUDA decoder the
buffer is page-locked.  Each batch takes a buffer of its own, so no
later batch writes rows that a copy still reads: PyTorch's caching host
allocator records each ``non_blocking`` copy from its page-locked memory
on the copy's stream and hands that memory out again only once the copy
has ended.  A CPU decoder (the tests) stages into plain memory and reads
the buffer itself.
"""
from __future__ import annotations

import numpy as np
import torch


class RowStaging:
    """One batch's (capacity, gh*gw, WORDS) int16 rows on the host,
    page-locked where the device is a CUDA one; the buffer is made at the
    first ``row`` and grows where the batch outgrows it (earlier rows
    copied over)."""

    def __init__(self, device, capacity: int = 8):
        self.device = torch.device(device)
        self.capacity = max(1, capacity)
        self._buf = None

    def _alloc(self, shape) -> torch.Tensor:
        return torch.empty(shape, dtype=torch.int16,
                           pin_memory=self.device.type == "cuda")

    def row(self, i: int, shape) -> np.ndarray:
        """Row i of the buffer, (gh*gw, WORDS) int16, to be written by the
        host."""
        shape = tuple(shape)
        buf = self._buf
        if buf is None:
            buf = self._buf = self._alloc((max(self.capacity, i + 1),) +
                                          shape)
        if tuple(buf.shape[1:]) != shape:
            raise ValueError(f"RowStaging.row: a {shape} row in a batch of "
                             f"{tuple(buf.shape[1:])} rows")
        if i >= buf.shape[0]:
            grown = self._alloc((max(2 * buf.shape[0], i + 1),) + shape)
            grown[:buf.shape[0]].copy_(buf)
            buf = self._buf = grown
        return buf[i].numpy()

    def rows(self, i0: int, i1: int) -> torch.Tensor:
        """Rows i0 .. i1 - 1 of the buffer, (i1 - i0, gh*gw, WORDS) int16
        on the host."""
        return self._buf[i0:i1]

    def upload(self, host: torch.Tensor) -> torch.Tensor:
        """``host`` (rows of the buffer) on the staging's device: one
        ``non_blocking`` copy on its current stream; on the CPU the rows
        themselves."""
        return host.to(self.device, non_blocking=True)
