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

Public API: ``hartallo_tpu_torch.api.Codec(config)`` (``device="cuda"``
by default; ``device="cpu"`` runs the kernels' plain twins).
"""
