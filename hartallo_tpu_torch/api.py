"""Public API of the port: ``hartallo_tpu.api.Codec`` for single-layer AVC.

``CodecConfig``, ``DecodeResult`` and ``EncodeResult`` are the JAX
package's own dataclasses.  The device is explicit: every tensor the codec
makes lives on ``device``.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from hartallo_tpu.api import CodecConfig, DecodeResult, EncodeResult  # noqa: F401


class Codec:
    """H.264 AVC codec instance on one torch device.

    ``decode(nal)`` consumes one NAL unit (no start code);
    ``decode_annexb(stream)`` a whole Annex-B stream; ``encode(frame)``
    one I420 frame and ``encode_frames(frames)`` a sequence of them.  SVC
    (several spatial or quality layers) is not ported yet."""

    def __init__(self, config: Optional[CodecConfig] = None, *, device):
        self.config = config or CodecConfig()
        if self.config.dqid_min >= 0 or self.config.dqid_max >= 0:
            raise NotImplementedError("SVC decode window not ported")
        self.device = device
        self._decoder = None
        self._encoder = None

    @property
    def decoder(self):
        if self._decoder is None:
            from hartallo_tpu_torch.decode.decoder import Decoder
            self._decoder = Decoder(device=self.device,
                                    tid_max=self.config.tid_max)
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
                raise NotImplementedError("SVC encoder not ported yet")
            from hartallo_tpu_torch.encode.encoder import Encoder
            self._encoder = Encoder(self.config, device=self.device)
        return self._encoder

    def encode(self, frame: np.ndarray, width: int = 0,
               height: int = 0) -> EncodeResult:
        return self.encoder.encode_frame(frame, width or self.config.width,
                                         height or self.config.height)

    def encode_frames(self, frames, width: int = 0,
                      height: int = 0) -> List[EncodeResult]:
        """Multi-frame encode: the device work of every picture is issued
        before the host packs the first one."""
        return self.encoder.encode_frames(frames,
                                          width or self.config.width,
                                          height or self.config.height)
