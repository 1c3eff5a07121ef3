"""Kernels: the least time the window's device-path queries could take,
over the device's busy time in the window, in percent.

The least time is the bytes those queries must read (roofline.packed_bytes
of each column each query reads, counted from the generated values) at the
card's published HBM bandwidth (peaks.json).
Nothing to read, no trace or an unknown card: no value."""

from benchmark import roofline


def read(ctx):
    dev, least, bw = ctx["device"], ctx["least_bytes"], ctx["hbm_bytes_per_s"]
    if dev is None or not least or not bw or dev["busy_s"] <= 0:
        return None
    return 100.0 * roofline.least_seconds(least, bw) / dev["busy_s"]
