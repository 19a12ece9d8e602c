"""Fetch, ms a frame: each batch's frames copied to the host
(``_BatchOut.fetch``), waiting for the batch's kernels included.
The program's own span ``decode.fetch`` (``hartallo_tpu_torch/tracing.py``),
read from the profiler's trace, over the window's frames; a program
without the span reads None."""

LABEL = "decode.fetch"


def read(trace):
    return trace.span_ms_per_frame(LABEL)
