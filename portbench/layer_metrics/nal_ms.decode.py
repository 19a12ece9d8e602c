"""Host NAL handling, ms a frame: ``find_nal_units``, and per NAL the
emulation-prevention strip, the NAL header, the parameter sets and the
PPS probe of a slice.
The program's own span ``decode.nal`` (``hartallo_tpu_torch/tracing.py``),
read from the profiler's trace, over the window's frames; a program
without the span reads None."""

LABEL = "decode.nal"


def read(trace):
    return trace.span_ms_per_frame(LABEL)
