"""Public API of the port: ``Codec`` for AVC and SVC on a torch device
(the card by default), ``Engine`` and ``Parser``.

``CodecConfig``, ``DecodeResult`` and ``EncodeResult`` are the port's own
copies of the dataclasses of ``hartallo_tpu/api.py``, field for field.
Every tensor the codec makes lives on ``device``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class CodecConfig:
    """Encoder/decoder knobs (reference ``hl_codec.h:16-150`` defaults from
    ``hl_codec.c:22-61``)."""
    width: int = 0
    height: int = 0
    fps: Tuple[int, int] = (1, 30)           # (num, den): den = frames/s
    gop_size: int = 30
    qp: int = 31
    rc_enabled: bool = False
    rc_bitrate: int = -1
    rc_bitrate_min: int = -1
    rc_bitrate_max: int = -1
    rc_qp_min: int = 2
    rc_qp_max: int = 51

    me_range: int = 16

    deblock: bool = True
    # False -> disable_deblocking_filter_idc=2 (no filtering across slice
    # boundaries): makes row-band slices fully independent, the mode the
    # sharded multi-chip pipeline uses
    deblock_slice_edges: bool = True
    threads: int = 1                         # host-side entropy workers
    slices: int = 1                          # slices per frame
    dqid_min: int = -1                       # SVC decode window
    dqid_max: int = -1
    entropy: str = "cavlc"                   # reference supports CAVLC only
    poc_type: int = 2                        # pic_order_cnt_type (0/1/2)
    # FMO (slice groups): >1 emits one slice per group walking the
    # MbToSliceGroupMap (8.2.2); map types supported for emit: 0/1/2/6
    num_slice_groups: int = 1
    slice_group_map_type: int = 0
    # temporal scalability: 2 -> alternate P frames are non-reference
    # (temporal_id 1, droppable); 1 = single temporal layer
    temporal_layers: int = 1
    svc_residual_pred: bool = True           # EP G.8.6.3 residual pred
    svc_inter_layer_p: bool = True           # EP base_mode (G.8.6.1) for
                                             # enhancement-layer P frames
    rc_basic_unit: bool = True               # per-MB-row QP adaptation
                                             # when rate control is on
    intra_in_p: bool = True                  # per-MB intra/inter choice
                                             # in P frames (slice.c:1797)
    # decode-side temporal window: drop slices with temporal_id > tid_max
    # (-1 = decode everything)
    tid_max: int = -1
    # SVC spatial layers: list of (width, height); empty = plain AVC
    layers: List[Tuple[int, int]] = field(default_factory=list)
    # SVC quality scalability: 2 -> each picture of the top spatial
    # layer is followed by a quality_id=1 refinement NAL (transform-
    # coefficient accumulation, G.8.5.1 family) coded at qp -
    # quality_qp_delta.  Requires temporal_layers == 1.
    quality_layers: int = 1
    quality_qp_delta: int = 6

    def add_layer(self, width: int, height: int) -> None:
        """Reference hl_codec_add_layer (hl_codec.c:95-131)."""
        self.layers.append((width, height))


@dataclass
class DecodeResult:
    frame: Optional[np.ndarray] = None       # packed I420 bytes as uint8 array
    width: int = 0
    height: int = 0
    dqid: int = 0
    poc: int = 0                             # picture order count (8.2.1)

    @property
    def has_frame(self) -> bool:
        return self.frame is not None


@dataclass
class EncodeResult:
    data: bytes = b""                        # Annex-B bytes (with start codes)
    headers: bytes = b""                     # SPS/PPS emitted this frame
    keyframe: bool = False
    temporal_id: int = 0                     # 0 = base temporal layer


class Engine:
    """Global init: mirrors hl_engine_init (binds kernels; here the CUDA
    kernels build at their first launch, ``kernels.load``)."""
    _initialized = False

    @classmethod
    def init(cls) -> None:
        cls._initialized = True

    @classmethod
    def initialized(cls) -> bool:
        return cls._initialized


class Parser:
    """Annex-B NAL bounds scanner (reference hl_parser_264.c)."""

    @staticmethod
    def find_nal_units(data: bytes):
        from hartallo_tpu_torch.bitio import find_nal_units
        return find_nal_units(data)


class Codec:
    """H.264 AVC/SVC codec instance on one torch device.

    ``decode(nal)`` consumes one NAL unit (no start code);
    ``decode_annexb(stream)`` a whole Annex-B stream; ``encode(frame)``
    one I420 frame and ``encode_frames(frames)`` a sequence of them.  With
    two or more spatial layers (``config.layers``) or ``quality_layers``
    2 the encoder is ``encode.svc.SvcEncoder``, fed one picture of each
    layer in turn, lowest layer first.  ``device`` is the card unless the
    caller names another (the tests pass "cpu")."""

    def __init__(self, config: Optional[CodecConfig] = None, *,
                 device="cuda"):
        self.config = config or CodecConfig()
        self.device = device
        self._decoder = None
        self._encoder = None

    @property
    def decoder(self):
        if self._decoder is None:
            from hartallo_tpu_torch.decode.decoder import Decoder
            self._decoder = Decoder(device=self.device,
                                    tid_max=self.config.tid_max,
                                    dqid_min=self.config.dqid_min,
                                    dqid_max=self.config.dqid_max)
        return self._decoder

    # -- decode -----------------------------------------------------------
    def decode(self, nal: bytes) -> DecodeResult:
        return self.decoder.decode_nal(nal)

    def decode_annexb(self, data: bytes,
                      tolerant: bool = True) -> List[DecodeResult]:
        """Whole-stream decode, batched; frames are fetched at the end.
        With ``tolerant`` (default) undecodable NALs are logged and
        skipped, the reference's behaviour (hl_codec_264.c:250-397)."""
        return self.decoder.decode_annexb(data, tolerant=tolerant)

    # -- encode -----------------------------------------------------------
    @property
    def encoder(self):
        if self._encoder is None:
            if len(self.config.layers) >= 2 or \
                    self.config.quality_layers >= 2:
                from hartallo_tpu_torch.encode.svc import SvcEncoder
                if not self.config.layers:
                    self.config.add_layer(self.config.width,
                                          self.config.height)
                self._encoder = SvcEncoder(self.config, device=self.device)
            else:
                from hartallo_tpu_torch.encode.encoder import Encoder
                self._encoder = Encoder(self.config, device=self.device)
        return self._encoder

    def encode(self, frame: np.ndarray, width: int = 0,
               height: int = 0) -> EncodeResult:
        return self.encoder.encode_frame(frame, width or self.config.width,
                                         height or self.config.height)

    def encode_frames(self, frames, width: int = 0,
                      height: int = 0) -> List[EncodeResult]:
        """Multi-frame encode: for single-layer AVC the device work of every
        picture is issued before the host packs the first one; the SVC
        encoder takes the pictures one at a time."""
        w = width or self.config.width
        h = height or self.config.height
        if hasattr(self.encoder, "encode_frames"):
            return self.encoder.encode_frames(frames, w, h)
        return [self.encoder.encode_frame(f, w, h) for f in frames]
