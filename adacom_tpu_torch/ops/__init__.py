"""Compute kernels: the bit-packing codec, the segment codec and the fused
table scan."""
