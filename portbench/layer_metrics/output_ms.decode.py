"""Output, ms a frame: each frame cut out of its batch
(``split_gop_out``).
The program's own span ``decode.output`` (``hartallo_tpu_torch/tracing.py``),
read from the profiler's trace, over the window's frames; a program
without the span reads None."""

LABEL = "decode.output"


def read(trace):
    return trace.span_ms_per_frame(LABEL)
