"""Host enqueue, ms a frame: MV derivation (``mv.derive_mvs``), the GOP
kernel's payload (``d_pool.pack_fast``), the scan's rows
(``pack_slice_rows``) and their page-locked staging
(``RowStaging.row``), timed around the program's calls (no synchronize),
over the window's frames."""
from portbench.capture import DECODE_HOOKS

LABEL = "enqueue"
WRAP = ("hartallo_tpu_torch.decode.mv:derive_mvs",
        "hartallo_tpu_torch.decode.d_pool:pack_fast",
        "hartallo_tpu_torch.decode.decoder:pack_slice_rows",
        "hartallo_tpu_torch.decode.staging:RowStaging.row")
HOOKS = DECODE_HOOKS


def read(trace):
    return trace.span_ms_per_frame(LABEL)
