"""Benchmark data and query sets (numpy only)."""
