"""Engine layer (L2): codec plugin registry + runtime option surface.

Port of ``hartallo_tpu/engine.py``, with one addition: the device.
``codec_create(..., device=...)`` keeps it on the ``ManagedCodec``, which
passes it to the plugin's ``create(config, device=...)``; the built-in
plugins create the port's ``Codec`` on it (the card unless the caller
names another device).

Reference parity: ``hl_codec.c:95-235`` — ``hl_codec_plugin_register``
(bounded table, add-or-replace), ``hl_codec_plugin_unregister`` (find +
compact), ``hl_codec_plugin_find`` (first match by type),
``hl_codec_create`` dispatch, ``hl_codec_add_layer`` validation
(increasing sizes; power-of-two ratio for SVC), and the
``hl_codec_set_option_*`` surface.  The reference's H.264 plugin
declines every option (``_hl_codec_264_set_option`` returns
HL_ERROR_NOT_IMPLEMENTED, ``hl_codec_264.c:70-77``); this
implementation goes further and applies the safe runtime rebinds —
knobs a new picture can legally pick up (qp, gop_size, rc_bitrate,
me_range, deblock) — while rejecting the rest with the reference's
not-implemented semantics.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from hartallo_tpu_torch.api import Codec, CodecConfig

MAX_PLUGINS = 8          # HL_CODEC_MAX_PLUGINS analog
MAX_LAYERS = 8           # HL_ENCODER_MAX_LAYERS analog

CODEC_TYPE_H264_AVC = "h264-avc"
CODEC_TYPE_H264_SVC = "h264-svc"

# options a running codec can pick up at the next picture boundary
_RUNTIME_OPTIONS: Dict[str, Callable] = {
    "qp": int,
    "gop_size": int,
    "rc_bitrate": int,
    "me_range": int,
    "deblock": bool,
    "quality_qp_delta": int,
}


class EngineError(Exception):
    """HL_ERROR_* analog: raised with the reference error name."""

    def __init__(self, code: str, msg: str = ""):
        self.code = code
        super().__init__(f"{code}: {msg}" if msg else code)


@dataclass
class CodecPlugin:
    """hl_codec_plugin_def_t analog; ``create(config, device=...)``."""
    type: str
    description: str
    create: Callable[..., Codec]


_plugins: List[Optional[CodecPlugin]] = [None] * MAX_PLUGINS


def plugin_register(plugin: CodecPlugin) -> None:
    """Add or replace (hl_codec.c:163-183)."""
    if plugin is None:
        raise EngineError("HL_ERROR_INVALID_PARAMETER")
    for i in range(MAX_PLUGINS):
        if _plugins[i] is None or _plugins[i] is plugin or \
                _plugins[i].type == plugin.type:
            _plugins[i] = plugin
            return
    raise EngineError("HL_ERROR_OUTOFBOUND",
                      f"{MAX_PLUGINS} plugins already registered")


def plugin_unregister(plugin: CodecPlugin) -> None:
    """Find + compact (hl_codec.c:185-215)."""
    if plugin is None:
        raise EngineError("HL_ERROR_INVALID_PARAMETER")
    try:
        i = _plugins.index(plugin)
    except ValueError:
        raise EngineError("HL_ERROR_NOT_FOUND") from None
    del _plugins[i]
    _plugins.append(None)


def plugin_find(codec_type: str) -> CodecPlugin:
    """First match by type (hl_codec.c:217-231)."""
    for p in _plugins:
        if p is not None and p.type == codec_type:
            return p
    raise EngineError("HL_ERROR_NOT_FOUND", codec_type)


def codec_create(codec_type: str, config: Optional[CodecConfig] = None, *,
                 device="cuda") -> "ManagedCodec":
    """hl_codec_create: plugin dispatch; the codec runs on ``device``."""
    plugin = plugin_find(codec_type)
    return ManagedCodec(plugin, config or CodecConfig(), device)


@dataclass
class ManagedCodec:
    """A codec handle with the engine-level layer/option surface."""
    plugin: CodecPlugin
    config: CodecConfig
    device: object = "cuda"
    _codec: Optional[Codec] = field(default=None, repr=False)

    # -- layers (hl_codec_add_layer, hl_codec.c:95-133) ----------------
    def add_layer(self, width: int, height: int, qp: int = -1,
                  fps: int = -1, strict_dyadic: bool = False) -> None:
        if len(self.config.layers) >= MAX_LAYERS:
            raise EngineError("HL_ERROR_OUTOFCAPACITY",
                              f"{len(self.config.layers)} already added")
        if self.config.layers:
            w0, h0 = self.config.layers[-1]
            if w0 >= width or h0 >= height:
                raise EngineError("HL_ERROR_INVALID_PARAMETER",
                                  "layers must be in increasing order")
            if strict_dyadic:
                # the reference's power-of-two gate (hl_codec.c:114-121);
                # opt-in here — this codec also supports ESS ratios
                rw, rh = width // w0, height // h0
                if rw & (rw - 1) or rh & (rh - 1):
                    raise EngineError("HL_ERROR_INVALID_PARAMETER",
                                      f"invalid image ratio ({rw}x{rh})")
        self.config.add_layer(width, height)

    def clear_layers(self) -> None:
        self.config.layers.clear()

    # -- options (hl_codec_set_option_*) -------------------------------
    def set_option(self, name: str, value) -> None:
        """Apply a runtime option; takes effect at the next picture.
        Unknown/unsafe options raise the reference's not-implemented
        error (the reference plugin declines ALL options)."""
        if name not in _RUNTIME_OPTIONS:
            raise EngineError("HL_ERROR_NOT_IMPLEMENTED", name)
        value = _RUNTIME_OPTIONS[name](value)
        setattr(self.config, name, value)
        enc = getattr(self._codec, "_encoder", None) if self._codec \
            else None
        if enc is None:
            return
        # propagate into live per-layer sub-configs (SvcEncoder copies
        # the config at construction)
        for sub in getattr(enc, "layers", []):
            setattr(sub.cfg, name, value)
        qenc = getattr(enc, "qenc", None)
        if qenc is not None and name != "qp":
            setattr(qenc.cfg, name, value)
        if qenc is not None and name in ("qp", "quality_qp_delta"):
            qenc.cfg.qp = max(0, min(51, self.config.qp -
                                     self.config.quality_qp_delta))

    # -- codec vtable (hl_codec_decode/encode) --------------------------
    @property
    def codec(self) -> Codec:
        if self._codec is None:
            self._codec = self.plugin.create(self.config,
                                             device=self.device)
        return self._codec

    def encode(self, frame, width: int = 0, height: int = 0):
        return self.codec.encode(frame, width, height)

    def decode(self, nal: bytes):
        return self.codec.decode(nal)

    def decode_annexb(self, data: bytes, tolerant: bool = True):
        return self.codec.decode_annexb(data, tolerant=tolerant)


def _register_builtins() -> None:
    plugin_register(CodecPlugin(
        type=CODEC_TYPE_H264_AVC,
        description="H.264 AVC (Baseline subset) CUDA codec",
        create=Codec))
    plugin_register(CodecPlugin(
        type=CODEC_TYPE_H264_SVC,
        description="H.264 SVC (Scalable Baseline subset) CUDA codec",
        create=Codec))


_register_builtins()
