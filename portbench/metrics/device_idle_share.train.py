"""The share of the profiled slice in which no kernel, copy or memset ran
on the device (the union of their intervals), in %."""


def read(run):
    s = run.summary
    if s is None or not s["device_ops"] or s["trace_window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["trace_window_s"])
