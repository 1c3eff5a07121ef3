"""Executor and host tiers: mean execute time of the window's queries,
from `Connection.last_profile["phases"]["execute_s"]` under PRAGMA
enable_profiling."""


def read(ctx):
    vals = [q.execute_s for q in ctx["done"] if q.execute_s is not None]
    return 1e3 * sum(vals) / len(vals) if vals else None
