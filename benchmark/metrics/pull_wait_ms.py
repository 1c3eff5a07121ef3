"""Device: the pull of the generic path's partials, mean ms per completed
query: wall time of the program's agg.pull span, in which the host waits
for the card to finish the query's kernels and every kernel queued before
them, then copies (benchmark/program_spans.py)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx["done"], program_spans.pull_wait_ns)
