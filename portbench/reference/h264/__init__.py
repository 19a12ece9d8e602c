"""A frozen copy of the plain (CPU) decode paths of ``hartallo_tpu_torch``.

Copied from the port at commit ``12ef82a`` with the import lines
rewritten to this package: the bit I/O, CAVLC, parameter sets, slice
headers, the pure-Python slice parse and MV derivation, the ``ops``
twins, ``decode/intra_recon.py`` and ``decode/inter_recon.py``: what
the plain decoder of ``portbench.reference.decode`` runs, and nothing
else.  The port's CUDA wrappers are left out (``ops/deblock_fast`` keeps
the deblock's plain parameter chain and filter alone).  ``native`` is a
stub that reports the C library absent, so every host step takes its
pure-Python path: the program's timed path runs the C parse and MV
derivation instead.

Later changes to the port do not reach this copy, so it stays the
yardstick that the benchmark holds the program's output against.
"""
