"""The device's idle share of the traced window: 1 minus the union of the
device's operation intervals (kernels, copies, fills) over the window."""


def read(trace):
    if trace.busy_s <= 0 or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
