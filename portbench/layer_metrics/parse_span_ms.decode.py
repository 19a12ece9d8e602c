"""Host parse, ms a frame, as the program times it: the calls of
``parse_slice_header`` and ``SliceDecoder.decode_slice_data`` (the
native CAVLC parse).
The program's own span ``decode.parse`` (``hartallo_tpu_torch/tracing.py``),
read from the profiler's trace, over the window's frames; a program
without the span reads None."""

LABEL = "decode.parse"


def read(trace):
    return trace.span_ms_per_frame(LABEL)
