"""Generic device path and fused tiers: pool-cache lookups that found the
stacked decoder arguments, in percent of the completed queries' lookups
(their scan.stack spans; benchmark/program_spans.py)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.share_pct(ctx["done"], "scan.stack", "hit", None)
