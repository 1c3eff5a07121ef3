"""Storage and codecs: the segment catalog's GetTotalDataSize at the end
of the window (packed bytes of compacted segments, plain bytes otherwise)."""


def read(ctx):
    return ctx["data_size_bytes"] / float(1 << 20)
