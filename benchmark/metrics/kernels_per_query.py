"""Device path: CUDA kernels in the traced window (torch.profiler; copies
and fills not counted) over the queries completed in it."""


def read(ctx):
    dev = ctx["device"]
    if dev is None or not ctx["done"]:
        return None
    return dev["kernels"] / len(ctx["done"])
