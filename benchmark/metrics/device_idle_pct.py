"""Device: the share of the traced window that no device operation
(kernel, copy or fill) covers, from the union of the profiler's intervals."""


def read(ctx):
    dev = ctx["device"]
    if dev is None or dev["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
