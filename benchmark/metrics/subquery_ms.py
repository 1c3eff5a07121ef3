"""Executor and host tiers: the uncorrelated subqueries a query evaluates
before its plan runs (Q15's max() over the revenue view, with the
aggregate under it), mean ms per completed query: wall time of the
program's outermost `subquery` spans."""

from benchmark import span_walls


def read(ctx):
    return span_walls.mean_wall_ms(ctx, ("subquery",))
