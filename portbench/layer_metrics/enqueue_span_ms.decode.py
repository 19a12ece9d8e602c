"""Host enqueue, ms a frame, as the program times it: the calls of
``mv.derive_mvs``, ``d_pool.pack_fast`` and ``pack_slice_rows`` with its
staging row.
The program's own span ``decode.enqueue`` (``hartallo_tpu_torch/tracing.py``),
read from the profiler's trace, over the window's frames; a program
without the span reads None."""

LABEL = "decode.enqueue"


def read(trace):
    return trace.span_ms_per_frame(LABEL)
