"""hartallo_tpu_torch: the H.264 codec of ``hartallo_tpu`` ported to
PyTorch and CUDA.

The module paths mirror ``hartallo_tpu``'s.  The host code (bit I/O,
CAVLC, the C slice parser and packer, parameter sets, slice headers, MV
derivation, DPB, POC, FMO, rate control, the API dataclasses) is the
port's own copy of the JAX package's modules, with only the import lines
rewritten (``native`` also builds its library under ``build/native/``).
Pixel work runs on torch tensors on one device, the card unless the
caller asks for another, and the whole-GOP decode kernel and the frame
deblock kernel are hand-written CUDA for Hopper (``csrc/``, built by
``kernels``).  This package never imports jax, nor anything of
``hartallo_tpu``.

Public API (``hartallo_tpu_torch.api``, as ``hartallo_tpu``'s): ``Engine``,
``Codec(config)`` / ``CodecConfig`` (``device="cuda"`` by default;
``device="cpu"`` runs the kernels' plain twins), ``Parser``,
``DecodeResult``, ``EncodeResult``; the plugin registry in ``engine``,
row-sharded encode and decode over a mesh of devices in
``parallel.shard``, and the command line in ``cli``.
"""

__version__ = "0.1.0"

from hartallo_tpu_torch.api import (  # noqa: F401
    Engine,
    CodecConfig,
    Codec,
    Parser,
    DecodeResult,
    EncodeResult,
)
