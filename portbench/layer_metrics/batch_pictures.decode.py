"""Pictures a batch: the window's kernel-route and scan pictures
(``Decoder.stats``) over the batch runs the decoder's flush launched
(the program's counter ``decode.batches``, its baseline taken when this
file is loaded, just before the window)."""
from portbench import program_counters

BASE = program_counters.now()


def read(trace):
    batches = program_counters.change(BASE, "decode.batches")
    if not batches:
        return None
    c = trace.counters
    return (c.get("kernel_pictures", 0) + c.get("scan_pictures", 0)) / batches
