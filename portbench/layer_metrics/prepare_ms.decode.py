"""Host prepare, ms a frame: the decoder's own work between the parse and
the enqueue (picture boundary, ``SliceData.create``, route checks,
reference list, weights, availability and filter masks, POC, DPB).
The program's own span ``decode.prepare`` (``hartallo_tpu_torch/tracing.py``),
read from the profiler's trace, over the window's frames; a program
without the span reads None."""

LABEL = "decode.prepare"


def read(trace):
    return trace.span_ms_per_frame(LABEL)
