"""Share of the traced window (%) with nothing running on the device:
one minus the union of kernel, memcpy and memset intervals over the
window (`devtrace.Trace`)."""


def read(run):
    t = run.traced
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
