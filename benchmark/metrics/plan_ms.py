"""Front end: mean plan time of the window's queries (parse cache, bind,
optimize), from `Connection.last_profile["phases"]["plan_s"]` under
PRAGMA enable_profiling."""


def read(ctx):
    vals = [q.plan_s for q in ctx["done"] if q.plan_s is not None]
    return 1e3 * sum(vals) / len(vals) if vals else None
