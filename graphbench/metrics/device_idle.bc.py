"""Share of the profiled slice in which no operation ran on the device: 1
minus the union of its kernel, copy and set intervals over the slice's
length, in percent."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
