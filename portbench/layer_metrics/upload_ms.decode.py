"""Upload, ms a frame: each batch's payload made and handed to the card
(``stack_payload`` and ``payload_to``, or ``RowStaging.upload``).
The program's own span ``decode.upload`` (``hartallo_tpu_torch/tracing.py``),
read from the profiler's trace, over the window's frames; a program
without the span reads None."""

LABEL = "decode.upload"


def read(trace):
    return trace.span_ms_per_frame(LABEL)
