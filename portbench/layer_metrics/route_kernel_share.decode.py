"""Share of the window's pictures that the decoder sent through the GOP
kernel (``Decoder.stats``: kernel over kernel, scan and general-route
pictures), layer: the route choice of ``decode/decoder.py``
(``_enqueue_batched``, ``d_pool.eligible``)."""


def read(trace):
    c = trace.counters
    total = sum(c.values()) if c else 0
    return 100.0 * c["kernel_pictures"] / total if total else None
