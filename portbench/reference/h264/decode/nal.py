"""NAL unit header parsing, including the SVC 3-byte extension header.

Reference parity: ``hl_codec_264.c:115-190`` (AVC + SVC NAL header parse) and
NAL type dispatch ``:250-397``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from portbench.reference.h264.bitio import BitReader

# NAL unit types (spec Table 7-1)
NAL_SLICE = 1
NAL_SLICE_DPA = 2
NAL_SLICE_DPB = 3
NAL_SLICE_DPC = 4
NAL_SLICE_IDR = 5
NAL_SEI = 6
NAL_SPS = 7
NAL_PPS = 8
NAL_AUD = 9
NAL_END_OF_SEQ = 10
NAL_END_OF_STREAM = 11
NAL_FILLER = 12
NAL_SPS_EXT = 13
NAL_PREFIX = 14          # SVC prefix NAL
NAL_SUBSET_SPS = 15      # SVC/MVC subset sequence parameter set
NAL_SLICE_AUX = 19
NAL_SLICE_EXT = 20       # SVC/MVC coded slice extension


@dataclass
class NalSvcExt:
    """SVC NAL header extension (spec G.7.3.1.1)."""
    idr_flag: int = 0
    priority_id: int = 0
    no_inter_layer_pred_flag: int = 1
    dependency_id: int = 0
    quality_id: int = 0
    temporal_id: int = 0
    use_ref_base_pic_flag: int = 0
    discardable_flag: int = 0
    output_flag: int = 1

    @property
    def dqid(self) -> int:
        """DQId = (dependency_id << 4) + quality_id (spec G-7)."""
        return (self.dependency_id << 4) + self.quality_id


@dataclass
class NalHeader:
    ref_idc: int
    type: int
    svc_extension_flag: int = 0
    svc: Optional[NalSvcExt] = None

    @property
    def is_slice(self) -> bool:
        return self.type in (NAL_SLICE, NAL_SLICE_IDR, NAL_SLICE_EXT)

    @property
    def is_idr(self) -> bool:
        if self.type == NAL_SLICE_IDR:
            return True
        if self.svc is not None:
            return bool(self.svc.idr_flag)
        return False

    @property
    def header_bytes(self) -> int:
        """Size of the NAL header in bytes (1, or 4 with SVC extension)."""
        return 4 if self.type in (NAL_PREFIX, NAL_SLICE_EXT) else 1


def parse_nal_header(r: BitReader) -> NalHeader:
    forbidden = r.u1()
    if forbidden:
        raise ValueError("forbidden_zero_bit set")
    ref_idc = r.u(2)
    ntype = r.u(5)
    hdr = NalHeader(ref_idc=ref_idc, type=ntype)
    if ntype in (NAL_PREFIX, NAL_SLICE_EXT):
        hdr.svc_extension_flag = r.u1()
        if hdr.svc_extension_flag:
            e = NalSvcExt()
            e.idr_flag = r.u1()
            e.priority_id = r.u(6)
            e.no_inter_layer_pred_flag = r.u1()
            e.dependency_id = r.u(3)
            e.quality_id = r.u(4)
            e.temporal_id = r.u(3)
            e.use_ref_base_pic_flag = r.u1()
            e.discardable_flag = r.u1()
            e.output_flag = r.u1()
            r.u(2)  # reserved_three_2bits
            hdr.svc = e
        else:
            # MVC extension: not supported (reference rejects MVC too,
            # hl_codec_264.c:185-189)
            raise NotImplementedError("MVC NAL extension not supported")
    return hdr


def write_nal_header(w, ref_idc: int, ntype: int,
                     svc: Optional[NalSvcExt] = None) -> None:
    w.u1(0)
    w.u(ref_idc, 2)
    w.u(ntype, 5)
    if ntype in (NAL_PREFIX, NAL_SLICE_EXT):
        assert svc is not None
        w.u1(1)  # svc_extension_flag
        w.u1(svc.idr_flag)
        w.u(svc.priority_id, 6)
        w.u1(svc.no_inter_layer_pred_flag)
        w.u(svc.dependency_id, 3)
        w.u(svc.quality_id, 4)
        w.u(svc.temporal_id, 3)
        w.u1(svc.use_ref_base_pic_flag)
        w.u1(svc.discardable_flag)
        w.u1(svc.output_flag)
        w.u(3, 2)  # reserved_three_2bits
