"""Executor and host tiers: a query's joins' own work (keys, the hash
table's build and probe, the output's gather; their sides' operators not
included), mean ms per completed query: wall time of the program's
outermost `join.build` and `join.probe` spans."""

from benchmark import span_walls


def read(ctx):
    return span_walls.mean_wall_ms(ctx, ("join.build", "join.probe"))
