"""Share of the window's kernel-route pictures whose payload the native
pass built: the change of the program's counter ``decode.pack_native``
(``d_pool.pack_fast``, once a picture that ``native/packc.c`` packed; its
baseline taken when this file is loaded, just before the window) over
the window's ``kernel_pictures`` (``Decoder.stats``), in %.  None on a
program without the counter and where no picture took the kernel
route."""
from portbench import program_counters

NAME = "decode.pack_native"
BASE = program_counters.now()


def read(trace):
    if BASE is None or NAME not in program_counters.now():
        return None
    kernel = trace.counters.get("kernel_pictures", 0)
    if not kernel:
        return None
    return 100.0 * program_counters.change(BASE, NAME) / kernel
