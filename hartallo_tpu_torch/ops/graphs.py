"""Replay of a recurring run of eager ops as one CUDA graph.

The plain twins of the port's wavefront kernels (the decoder's intra
reconstruction and the deblock) are some 1,000 small ops per diagonal,
paced by the host's dispatch of each op; ``chip_smoke.py`` holds every
kernel call of a path against them.  ``replayed`` runs such a function
eagerly the first time its inputs' shapes are seen on a device, records
the same ops into a CUDA graph the second time, and from then on copies
the inputs into the graph's own and replays it: the same kernels on the
same values, launched as one graph instead of one by one from Python.  The
function must not read device values on the host and must make no
host-to-device copy (its constant tables cached on the device before).
"""
from __future__ import annotations

import torch

_SEEN = set()        # keys run once eagerly
_GRAPHS = {}         # key -> (graph, its input tensors, its outputs)


def replayed(fn, name: str, *args):
    """fn(*args) for CUDA tensors ``args`` (all on one device), returning a
    tuple of new tensors.  ``name`` with the inputs' shapes, dtypes and
    device keys the graph, so what ``fn`` does may depend only on those
    and on the inputs' values.  Graphs are kept for the process's life."""
    dev = args[0].device
    key = (name, dev, tuple((a.shape, a.dtype) for a in args))
    entry = _GRAPHS.get(key)
    if entry is None:
        if key not in _SEEN:
            _SEEN.add(key)
            return fn(*args)
        static = tuple(a.clone(memory_format=torch.contiguous_format)
                       for a in args)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), torch.cuda.graph(graph):
            out = fn(*static)
        entry = _GRAPHS[key] = (graph, static, out)
    graph, static, out = entry
    for s, a in zip(static, args):
        s.copy_(a)
    graph.replay()
    return tuple(o.clone() for o in out)
