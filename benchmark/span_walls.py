"""Per-layer metrics that read the wall time of some of the program's spans
(benchmark/program_spans.py), mean ms per completed query."""

from benchmark import program_spans


def mean_wall_ms(ctx, names) -> float | None:
    """Mean per completed query of the wall time of the outermost spans
    named in `names`; None where the program records no such span (an
    older checkout), so that the metric is left out of the line."""
    if not any(sp["name"] in names for p in program_spans.program_profiles()
               for sp in p.get("spans", ())):
        return None

    def wall_ns(profile: dict) -> int:
        return sum(sp["end_ns"] - sp["start_ns"]
                   for sp in program_spans.outermost(profile["spans"], names))

    return program_spans.mean_ms(ctx["done"], wall_ns)
