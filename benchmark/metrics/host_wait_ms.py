"""Executor and host tiers: time the query's thread spent off the CPU
while executing, mean ms per completed query: wall minus thread-CPU time
of the program's execute span, less that of its agg.pull and agg.fused
spans (the waits for the card). What is left waits for the GIL, a lock or
a full launch queue (benchmark/program_spans.py)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx["done"], program_spans.host_wait_ns)
