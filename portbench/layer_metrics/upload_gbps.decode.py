"""Upload rate, GB/s: the bytes of batch payloads and scan rows the
decoder handed to the card over the window (the program's counter
``decode.upload_bytes``, its baseline taken when this file is loaded,
just before the window) over the summed device time of ``Memcpy HtoD``
in the profiler's trace (which also holds the kernels' constant tables,
a few KB a launch, that the counter leaves out)."""
from portbench import program_counters

BASE = program_counters.now()


def read(trace):
    return program_counters.gbps(BASE, "decode.upload_bytes", trace,
                                 "Memcpy HtoD")
