"""Public API of the port: the decode side of ``hartallo_tpu.api.Codec``.

``CodecConfig`` and ``DecodeResult`` are the JAX package's own
dataclasses.  The device is explicit: every tensor the codec makes lives
on ``device``.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from hartallo_tpu.api import CodecConfig, DecodeResult, EncodeResult  # noqa: F401


class Codec:
    """H.264 AVC codec instance on one torch device.

    ``decode(nal)`` consumes one NAL unit (no start code);
    ``decode_annexb(stream)`` a whole Annex-B stream.  Encoding is not
    ported yet."""

    def __init__(self, config: Optional[CodecConfig] = None, *, device):
        self.config = config or CodecConfig()
        if self.config.dqid_min >= 0 or self.config.dqid_max >= 0:
            raise NotImplementedError("SVC decode window not ported")
        self.device = device
        self._decoder = None

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
    def encode(self, frame: np.ndarray, width: int = 0,
               height: int = 0) -> EncodeResult:
        raise NotImplementedError("encoder not ported yet")

    def encode_frames(self, frames, width: int = 0,
                      height: int = 0) -> List[EncodeResult]:
        raise NotImplementedError("encoder not ported yet")
