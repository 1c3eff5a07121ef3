"""The control of a cell's comparison: the plain reference computed in
float32, the step below the configuration's exact arithmetic, put in the
program's place over the requests that a run of the cell sends, and judged
by the same comparison against the exact reference. Its readings set the
upper end of each limit in ``limits/<cell>.json``; it has to come out as
not correct.

    python3 benchmark/control.py --workload <cell> --seed <n> [--per-client N]

Runs at the cell's own size (the configuration's file) on the host; the
benchmark's own runs never run it."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def readings(spec: dict, cell: dict, seed: int, per_client: int,
             desc: dict | None = None) -> dict:
    from benchmark import compare, registry, traffic

    config = cell["config"]
    desc = desc if desc is not None else registry.config_desc(spec, config)
    data = registry.load_module("configs", config).generate(desc, seed)
    mix = traffic.Mix(registry.load_json("traffic", cell["traffic"]), desc)
    refs = registry.load_module("reference", config)
    exact, low = refs.Reference(data, "exact"), refs.Reference(data, "float32")
    tally = compare.Tally()
    cache = {}
    for stream in mix.clients(seed):
        for k in range(per_client):
            tpl, params, _ = stream.request(k)
            key = (tpl.answer, tuple(sorted(params.items())))
            if key not in cache:
                cache[key] = (low.answer(tpl.answer, params), exact.answer(tpl.answer, params))
            tally.add(key, *cache[key])
    limits = registry.load_json("limits", cell["name"])
    correct, checks = compare.judge(tally, limits, 0)
    return {"cell": cell["name"], "seed": seed, "answers": tally.answers,
            "correct": correct, "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--per-client", type=int, default=200)
    args = ap.parse_args(argv)
    from benchmark import registry

    spec = registry.load_spec()
    t0 = time.perf_counter()
    out = readings(spec, registry.cell(spec, args.workload), args.seed, args.per_client)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main())
