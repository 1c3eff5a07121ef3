"""One run of one cell: set-up, the measured window, the check, the line.

Set-up (counted in `setup_s`, from the start of the process): import the
program, draw the configuration's data and each client's requests from the
seed, load the tables into one `adacom_tpu_torch.Database`, compact them,
and send each of the mix's query templates once, cold.

The window: each client is one `Connection` of that database on a thread
of its own, in a closed loop. A query is timed from `Connection.query(sql)`
to the return of `.fetchall()`, which ends in a host pull. The rate counts
the queries completed inside the window; a query still running at its end
completes, is checked, and is not counted.

After the window: the device's peak memory is read, the program's state is
freed, and the plain reference works out every answer again from the
generated data. With `--trace 1` the window also runs under
`PRAGMA enable_profiling` and torch.profiler, and the line carries the
per-layer metrics instead of the end-to-end ones."""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import threading
import time

import numpy as np

from benchmark import compare, registry, roofline, trace, traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "adacom_tpu")
MIB = float(1 << 20)
APPEND_CHUNK_ROWS = 1 << 23


class Query:
    __slots__ = ("client", "template", "params", "t0", "t_query", "t1", "rows",
                 "error", "plan_s", "execute_s")

    def __init__(self, client, template, params, t0):
        self.client, self.template, self.params, self.t0 = client, template, params, t0
        self.t_query = self.t1 = None
        self.rows = self.error = self.plan_s = self.execute_s = None


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    """Top-level names in sys.modules that are JAX or the JAX package,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv, process_start: float) -> int:
    args = parse_args(argv)
    spec = registry.load_spec()
    cell = registry.cell(spec, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: cell {cell['name']} needs {cell['chips']} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        import adacom_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the program is not in this checkout: {e}", file=sys.stderr)
        return 4
    result = run_cell(spec, cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", process_start)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process loaded {found}", file=sys.stderr)
        return 5
    for name, (value, limit) in result["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def log(msg: str):
    print(f"[benchmark {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


# ---------------------------------------------------------------- set-up
def load_tables(con, db, desc: dict, data: dict):
    """CREATE each table of the configuration, append its generated columns
    through the appender in chunks, and compact every segment (the paper's
    CompactAllSegments)."""
    for table, cols in desc["tables"].items():
        con.query(f"CREATE TABLE {table}("
                  + ", ".join(f"{c} {t}" for c, t in cols.items()) + ")")
        arrays = data[table]
        n = len(next(iter(arrays.values())))
        app = con.appender(table)
        for start in range(0, n, APPEND_CHUNK_ROWS):
            app.append_columns({c: arrays[c][start:start + APPEND_CHUNK_ROWS] for c in cols})
        app.close()
    db.catalog.get_column_segment_catalog().compact_all_segments()


def open_database(desc: dict, platform: str):
    import adacom_tpu_torch as att

    cfg = att.DBConfig()
    for key, value in desc.get("settings", {}).items():
        cfg.set_option(key, value)
    return att.Database(config=cfg, platform=platform)


# ---------------------------------------------------------------- window
def run_window(db, streams: list, seconds: float, profiling: bool, spans, device_trace):
    """The measured window. Returns (queries, t_start, t_end)."""
    cons = [db.connect() for _ in streams]
    per_client = [[] for _ in streams]
    ready = threading.Barrier(len(streams) + 1)
    window = {}

    def client(c):
        con, stream, out = cons[c], streams[c], per_client[c]
        ready.wait()
        end = window["end"]
        k = 0
        while time.perf_counter() < end:
            tpl, params, sql = stream.request(k)
            k += 1
            q = Query(c, tpl, params, time.perf_counter())
            out.append(q)
            try:
                res = con.query(sql)
                q.t_query = time.perf_counter()
                q.rows = res.fetchall()
                q.t1 = time.perf_counter()
            except Exception as e:  # a failed query is counted and the run goes on
                q.error = f"{type(e).__name__}: {e}"
                q.t1 = time.perf_counter()
                continue
            if profiling and con.last_profile is not None:
                ph = con.last_profile["phases"]
                q.plan_s, q.execute_s = ph["plan_s"], ph["execute_s"]
            if spans is not None:
                spans.add(c, f"query {tpl.name}", q.t0, q.t_query)
                spans.add(c, f"fetch {tpl.name}", q.t_query, q.t1)
                if q.execute_s is not None:
                    spans.add(c, f"execute {tpl.name}", q.t_query - q.execute_s, q.t_query)
                    spans.add(c, f"plan {tpl.name}", q.t_query - q.execute_s - q.plan_s,
                              q.t_query - q.execute_s)

    threads = [threading.Thread(target=client, args=(c,), name=f"bench-client-{c}")
               for c in range(len(streams))]
    for t in threads:
        t.start()
    if device_trace is not None:
        device_trace.start()
        window["start"] = device_trace.mark()
    else:
        window["start"] = time.perf_counter()
    window["end"] = window["start"] + seconds
    ready.wait()
    for t in threads:
        # a query in flight at the end may finish a minute late: late, not lost
        t.join(timeout=max(0.0, window["end"] + 60.0 - time.perf_counter()))
    stuck = [t.name for t in threads if t.is_alive()]
    if stuck:
        raise RuntimeError(f"clients still running a minute after the window: {stuck}")
    queries = [q for qs in per_client for q in qs]
    return queries, window["start"], window["end"]


# ---------------------------------------------------------------- check
def check_answers(ref, queries: list) -> compare.Tally:
    """Every answer the window produced, against the reference's answer to
    the same template and parameters."""
    tally = compare.Tally()
    cache = {}
    for q in queries:
        if q.error is not None:
            continue
        key = (q.template.answer, tuple(sorted(q.params.items())))
        want = cache.get(key)
        if want is None:
            want = cache[key] = ref.answer(q.template.answer, q.params)
        tally.add(key, q.rows, want)
    return tally


def least_bytes(mix: traffic.Mix, data: dict, done: list) -> int:
    """Bytes that the window's completed queries had to read on the device
    (roofline.packed_bytes of each column each reads)."""
    per_column = {}
    per_template = {}
    for name, tpl in mix.templates.items():
        total = 0
        for ref in tpl.reads:
            if ref not in per_column:
                table, col = ref.split(".")
                per_column[ref] = roofline.packed_bytes(data[table][col])
            total += per_column[ref]
        per_template[name] = total
    return sum(per_template[q.template.name] for q in done)


def card_power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
        return out.splitlines()[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


# ---------------------------------------------------------------- a run
def run_cell(spec: dict, cell: dict, seed: int, seconds: float, traced: bool,
             platform: str, process_start: float, desc: dict | None = None) -> dict:
    """One run of `cell`; returns the result line as a dict. `desc`
    replaces the configuration's file (a test's small copy)."""
    import torch

    from adacom_tpu_torch.ops import fused_scan, grouped_scan
    from adacom_tpu_torch.exec import device_scan

    on_card = platform != "cpu"
    config = cell["config"]
    desc = desc if desc is not None else registry.config_desc(spec, config)
    generator = registry.load_module("configs", config)
    mix = traffic.Mix(registry.load_json("traffic", cell["traffic"]), desc)
    limits = registry.load_json("limits", cell["name"])
    log(f"cell {cell['name']} seed {seed}: generating")
    data = generator.generate(desc, seed)
    streams = mix.clients(seed)
    log("loading")
    db = open_database(desc, platform)
    con = db.connect()
    load_tables(con, db, desc, data)
    if on_card:
        from adacom_tpu_torch.utils.warmup import ensure_transfer_warm

        ensure_transfer_warm(db.device)
    log("warming up")
    for tpl, params, sql in mix.warmup(seed):
        con.query(sql).fetchall()
    if traced:
        db.config.enable_profiling = True
    if on_card:
        torch.cuda.synchronize(db.device)
    gc.collect()
    gc.freeze()  # the loaded arrays never move into a collection inside the window
    counters = (fused_scan.KERNEL_LAUNCHES, grouped_scan.MULTI_LAUNCHES, device_scan.RUNS)
    spans = trace.Spans(len(streams)) if traced else None
    device_trace = trace.DeviceTrace(db.device) if traced and on_card else None
    setup_s = time.perf_counter() - process_start
    log(f"set-up {setup_s:.3f} s; window of {seconds} s with {len(streams)} clients")

    queries, t0, t1 = run_window(db, streams, seconds, traced, spans, device_trace)

    events = device_trace.stop() if device_trace is not None else None
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(db.device) if on_card else None
    data_size = db.catalog.get_column_segment_catalog().get_total_data_size()
    routes = {"b1_launches": fused_scan.KERNEL_LAUNCHES - counters[0],
              "b3_launches": grouped_scan.MULTI_LAUNCHES - counters[1],
              "device_scan_runs": device_scan.RUNS - counters[2]}
    del con, db
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    done = [q for q in queries if q.error is None and q.t1 <= t1]
    failed = [q for q in queries if q.error is not None]
    for q in failed[:5]:
        log(f"failed: {q.template.name} {q.params}: {q.error}")
    log(f"{len(done)} queries completed in the window, {len(failed)} failed; routes {routes}")

    t_check = time.perf_counter()
    ref = registry.load_module("reference", config).Reference(data, "exact")
    tally = check_answers(ref, queries)
    correct, checks = compare.judge(tally, limits, len(failed))
    log(f"checked {tally.answers} answers in {time.perf_counter() - t_check:.1f} s; "
        f"first wrong {tally.first_wrong}; widest gap {tally.widest}")

    latencies = np.array([q.t1 - q.t0 for q in done])
    end_to_end = {
        "queries_per_s": len(done) / seconds,
        "query_p95_ms": float(np.percentile(latencies, 95) * 1e3) if len(done) else None,
        "device_peak_mib": peak / MIB if peak is not None else None,
        "setup_s": setup_s,
    }
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(torch.cuda.current_device()) if on_card else "cpu",
              "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(queries), "failed": len(failed)}
    if traced:
        summary = None
        if events is not None:
            spans.freeze()
            summary = trace.reduce_events(events, t0, t1, spans)
            device["busy_s"] = summary["busy_s"]
            device["window_s"] = summary["window_s"]
            log(f"device trace aligned by {'marker' if device_trace.aligned_by_marker else 'wall clock'}")
        peaks = registry.load_json(".", "peaks")["cards"].get(device["kind"], {})
        ctx = {
            "window_s": seconds,
            "done": done,
            "latencies_s": latencies,
            "data_size_bytes": data_size,
            "device": summary,
            "least_bytes": least_bytes(mix, data, done) if summary is not None else None,
            "hbm_bytes_per_s": peaks.get("hbm_bytes_per_s"),
        }
        values = {m["name"]: (registry.load_module("metrics", m["name"]).read(ctx), m["unit"])
                  for m in registry.metrics_of(spec, "per_layer", cell["name"])}
        if summary is not None:
            result["breakdown"] = {"device_ops": [[n, s] for n, s in summary["device_ops"]],
                                   "idle_gaps": summary["idle_gaps"]}
    else:
        values = {m["name"]: (end_to_end[m["name"]], m["unit"])
                  for m in registry.metrics_of(spec, "end_to_end", cell["name"])}
    result["metrics"] = {n: {"value": v, "unit": u} for n, (v, u) in values.items()
                         if v is not None}
    result["device"] = device
    if on_card:
        log(f"card: {card_power_limit()}")
    result["checks"] = checks
    return result

