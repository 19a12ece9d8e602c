"""hartallo_tpu_torch: the H.264 codec of ``hartallo_tpu`` ported to
PyTorch and CUDA.

The module paths mirror ``hartallo_tpu``'s.  Host code that imports no
JAX (bit I/O, CAVLC, the C slice parser and packer, parameter sets,
slice headers, MV derivation, DPB, POC, FMO, rate control, the API
dataclasses) is imported from ``hartallo_tpu``; pixel work runs on torch
tensors on an explicit device, and the whole-GOP decode kernel and the
frame deblock kernel are hand-written CUDA for Hopper (``csrc/``, built by
``kernels``).  This package never imports jax.

Public API: ``hartallo_tpu_torch.api.Codec(config, device=...)``.
"""
