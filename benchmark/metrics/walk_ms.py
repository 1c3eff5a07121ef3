"""Executor and host tiers: the per-segment walk, mean ms per completed
query: wall time of the program's scan.snapshot, scan.pools (the segment
loop with the zonemaps) and scan.stack (the pool-cache lookup, the stack
on a miss) spans (benchmark/program_spans.py)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx["done"], program_spans.walk_ns)
