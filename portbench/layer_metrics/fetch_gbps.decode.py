"""Fetch rate, GB/s: the bytes of output frames the decoder copied to the
host over the window (the program's counter ``decode.fetch_bytes``, its
baseline taken when this file is loaded, just before the window) over
the summed device time of ``Memcpy DtoH`` in the profiler's trace."""
from portbench import program_counters

BASE = program_counters.now()


def read(trace):
    return program_counters.gbps(BASE, "decode.fetch_bytes", trace,
                                 "Memcpy DtoH")
