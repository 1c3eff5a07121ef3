"""Executor and host tiers: segments the zonemaps kept over the segments
in the pinned snapshot, in percent, summed over the completed queries'
scan.pools spans (benchmark/program_spans.py)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.share_pct(ctx["done"], "scan.pools", "segments_kept", "segments")
