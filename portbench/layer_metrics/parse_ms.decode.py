"""Host parse, ms a frame: the slice headers (``parse_slice_header``) and
the slice data (``SliceDecoder.decode_slice_data``, the native CAVLC
parse), timed around the program's calls from the benchmark (no
synchronize), over the window's frames."""
from portbench.capture import DECODE_HOOKS

LABEL = "parse"
WRAP = ("hartallo_tpu_torch.decode.decoder:parse_slice_header",
        "hartallo_tpu_torch.decode.slice_decode:SliceDecoder.decode_slice_data")
HOOKS = DECODE_HOOKS


def read(trace):
    return trace.span_ms_per_frame(LABEL)
