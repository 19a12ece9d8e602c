"""Decoded picture buffer + reference list construction (spec 8.2.4/8.2.5).

Reference parity: ``hl_codec_264_dpb.c`` (frame stores, sliding window +
adaptive MMCO marking ``:190-401``) and ``hl_codec_264_reflist.c``
(RefPicList0 init ``:206-240`` + modification ``:241-409``).

Frames are stored as edge-replicate padded int32 device planes ready for
motion compensation (the analog of the reference's per-resolution interpol
index objects, ``hl_codec_264_dpb.c:109-123``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class Frame:
    frame_num: int
    poc: int
    planes_pad: Optional[tuple]  # (Y, U, V) padded jnp arrays (MC-ready);
    #                              None while the recon lives only in the
    #                              batched decoder's device ring
    is_ref: bool = True
    long_term: bool = False
    long_term_idx: int = -1
    slot: int = -1               # ring slot (batched decode path)
    in_ring: bool = False        # recon (incl. half-pel stack) in the ring


@dataclass
class DPB:
    max_refs: int = 1
    frames: List[Frame] = field(default_factory=list)

    def clear(self) -> None:
        self.frames.clear()

    def add(self, frame: Frame, mmcos=None, idr: bool = False,
            long_term_reference_flag: int = 0) -> None:
        if idr:
            self.clear()
            frame.long_term = bool(long_term_reference_flag)
            if frame.long_term:
                frame.long_term_idx = 0
        if mmcos:
            self._apply_mmco(frame, mmcos)
        self.frames.append(frame)
        # sliding window (8.2.5.3): drop oldest short-term refs
        short = [f for f in self.frames if f.is_ref and not f.long_term]
        while len([f for f in self.frames if f.is_ref]) > \
                max(1, self.max_refs) and short:
            oldest = short.pop(0)
            oldest.is_ref = False
        # retire non-reference frames (output is immediate in this
        # decoder: no B-frame reordering, matching the reference scope)
        self.frames = [f for f in self.frames if f.is_ref]

    def _apply_mmco(self, cur: Frame, mmcos) -> None:
        for m in mmcos:
            if m.op == 1:      # unmark short-term
                pic_num = cur.frame_num - (m.value1 + 1)
                for f in self.frames:
                    if f.is_ref and not f.long_term and \
                            f.frame_num == pic_num:
                        f.is_ref = False
            elif m.op == 2:    # unmark long-term
                for f in self.frames:
                    if f.long_term and f.long_term_idx == m.value1:
                        f.is_ref = False
            elif m.op == 3:    # short-term -> long-term
                pic_num = cur.frame_num - (m.value1 + 1)
                for f in self.frames:
                    if f.is_ref and not f.long_term and \
                            f.frame_num == pic_num:
                        f.long_term = True
                        f.long_term_idx = m.value2
            elif m.op == 4:    # max long-term index
                for f in self.frames:
                    if f.long_term and f.long_term_idx >= m.value1:
                        f.is_ref = False
            elif m.op == 5:    # reset
                self.clear()
            elif m.op == 6:    # current -> long-term
                cur.long_term = True
                cur.long_term_idx = m.value1

    # ------------------------------------------------------------------
    def ref_list_p(self, cur_frame_num: int, max_frame_num: int,
                   mods=None, num_active: int = 1) -> List[Frame]:
        """RefPicList0 for a P slice (8.2.4.2.1 + 8.2.4.3)."""
        def pic_num(f: Frame) -> int:
            return f.frame_num if f.frame_num <= cur_frame_num else \
                f.frame_num - max_frame_num

        short = sorted([f for f in self.frames
                        if f.is_ref and not f.long_term],
                       key=pic_num, reverse=True)
        lt = sorted([f for f in self.frames if f.is_ref and f.long_term],
                    key=lambda f: f.long_term_idx)
        lst = short + lt
        if mods:
            pred = cur_frame_num
            for ridx, mod in enumerate(mods):
                if mod.idc in (0, 1):
                    if mod.idc == 0:
                        pred -= mod.value + 1
                    else:
                        pred += mod.value + 1
                    pred = (pred + max_frame_num) % max_frame_num
                    target = None
                    for f in lst:
                        if not f.long_term and \
                                f.frame_num % max_frame_num == pred:
                            target = f
                            break
                    if target is not None:
                        lst.remove(target)
                        lst.insert(min(ridx, len(lst)), target)
                elif mod.idc == 2:
                    target = None
                    for f in lst:
                        if f.long_term and f.long_term_idx == mod.value:
                            target = f
                            break
                    if target is not None:
                        lst.remove(target)
                        lst.insert(min(ridx, len(lst)), target)
        return lst[:max(num_active, 1)] if num_active else lst
