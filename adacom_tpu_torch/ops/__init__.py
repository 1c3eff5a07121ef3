"""Compute ops: the bit-packing and segment codecs, the generic codecs, the
aggregation and selection ops of the generic device path, and the fused
scan kernels' wrappers."""
