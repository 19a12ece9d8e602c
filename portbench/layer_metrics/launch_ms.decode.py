"""Launch, ms a frame: the rest of the decoder's flush (the ring, the
references synced into it, ``decode_gop_fast`` / ``decode_gop``, the
output's bookkeeping).
The program's own span ``decode.launch`` (``hartallo_tpu_torch/tracing.py``),
read from the profiler's trace, over the window's frames; a program
without the span reads None."""

LABEL = "decode.launch"


def read(trace):
    return trace.span_ms_per_frame(LABEL)
