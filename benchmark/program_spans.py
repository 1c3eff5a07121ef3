"""The program's own spans (`adacom_tpu_torch.utils.trace`, recorded under
PRAGMA enable_profiling, which a traced run turns on) as the benchmark
reads them.

- `statements(done)`: the program's profiles of the window's completed
  queries, matched to them on the host clock; the per-layer metrics
  `walk_ms`, `host_wait_ms`, `pull_wait_ms`, `zonemap_kept_pct` and
  `pool_cache_hit_pct` read them. A program without the spans (an older
  checkout) gives none, and those metrics then read nothing.
- `ProgramSpans` and `LaunchTrace`: `trace.Spans` and `trace.DeviceTrace`
  that also hold the program's spans of each client and the CUDA
  runtime's launch records, so that idle gaps are named by the program
  span each client was in, and each kernel's device time by the program
  span its launch was made in (`attribute`). `benchmark/breakdown.py`
  runs a cell with them.

Host times here are `time.perf_counter()` seconds; the program's spans
are `time.perf_counter_ns()` on the same clock."""

from __future__ import annotations

import bisect
import ctypes
import threading
from collections import Counter, defaultdict

from benchmark import trace

# the per-segment walk: the snapshot, the segment loop with the zonemaps,
# the pool-cache lookup (and the stack on a miss)
WALK = ("scan.snapshot", "scan.pools", "scan.stack")
# spans in which the host waits for the card by design: a pull, a fused
# tier's launch and pull
DEVICE_WAITS = ("agg.pull", "agg.fused")
DECODE = ("scan.decode", "scan.filter")
SCATTER = ("agg.partials",)


def program_profiles() -> list:
    """Every profile the program keeps (its last statements run with
    profiling on), or [] where the program keeps none."""
    try:
        from adacom_tpu_torch.utils import trace as program_trace
    except ImportError:
        return []
    recent = getattr(program_trace, "recent", None)
    return recent() if recent is not None else []


def _root(profile: dict):
    spans = profile.get("spans")
    return spans[0] if spans and spans[0]["end_ns"] is not None else None


def statements(done: list, profiles: list | None = None) -> list:
    """The SELECT profiles of the completed queries `done` (harness.Query):
    a profile belongs to a query when its root span lies inside the
    query's [t0, t_query] on that query's client. A connection's profiles
    share the token of their query ids, and each token goes to the client
    whose queries hold most of its profiles."""
    profiles = program_profiles() if profiles is None else profiles
    windows = defaultdict(list)
    for q in done:
        windows[q.client].append((q.t0 * 1e9, q.t_query * 1e9))
    for w in windows.values():
        w.sort()
    starts = {c: [w[0] for w in ws] for c, ws in windows.items()}

    def clients_holding(root):
        out = []
        for c, ws in windows.items():
            k = bisect.bisect_right(starts[c], root["start_ns"]) - 1
            if k >= 0 and root["end_ns"] <= ws[k][1]:
                out.append(c)
        return out

    held = []
    votes = defaultdict(Counter)
    for p in profiles:
        root = _root(p)
        if p.get("statement") != "SelectStmt" or root is None:
            continue
        token = p["query_id"].split(".")[0]
        cs = clients_holding(root)
        votes[token].update(cs)
        held.append((p, token, cs))
    owner = {t: v.most_common(1)[0][0] for t, v in votes.items() if v}
    return [p for p, token, cs in held if owner.get(token) in cs]


def _wall(sp) -> int:
    return sp["end_ns"] - sp["start_ns"]


def _off_cpu(sp) -> int:
    return _wall(sp) - (sp["cpu_end_ns"] - sp["cpu_start_ns"])


def outermost(spans: list, names) -> list:
    """The closed spans named in `names` that no span named in `names`
    holds (a snapshot pinned inside scan.pools counts once)."""
    by_id = {sp["id"]: sp for sp in spans}
    out = []
    for sp in spans:
        if sp["name"] not in names or sp["end_ns"] is None:
            continue
        up = by_id.get(sp["parent"])
        while up is not None and up["name"] not in names:
            up = by_id.get(up["parent"])
        if up is None:
            out.append(sp)
    return out


def walk_ns(profile: dict) -> int:
    return sum(_wall(sp) for sp in outermost(profile["spans"], WALK))


def host_wait_ns(profile: dict) -> int:
    """Time the statement's thread spent off the CPU while executing
    (waiting for the GIL, a lock or a full launch queue), less the waits
    for the card inside pulls and fused launches."""
    spans = profile["spans"]
    ex = [sp for sp in spans if sp["name"] == "execute" and sp["end_ns"] is not None]
    return (sum(_off_cpu(sp) for sp in ex)
            - sum(_off_cpu(sp) for sp in outermost(spans, DEVICE_WAITS)))


def pull_wait_ns(profile: dict) -> int:
    return sum(_wall(sp) for sp in outermost(profile["spans"], ("agg.pull",)))


def mean_ms(done: list, per_statement) -> float | None:
    """Mean per completed query of per_statement(profile) nanoseconds, in
    ms, over the queries whose profile was found; None without any."""
    found = statements(done)
    if not found:
        return None
    return sum(per_statement(p) for p in found) / len(found) / 1e6


def share_pct(done: list, name: str, part: str, whole: str | None) -> float | None:
    """100 x the sum of count `part` over the sum of count `whole` (each
    span counting 1 where `whole` is None) over the spans called `name` of
    the completed queries' profiles; None where nothing was counted."""
    num = den = 0
    for p in statements(done):
        for sp in p["spans"]:
            if sp["name"] == name and part in sp["counts"]:
                num += sp["counts"][part]
                den += 1 if whole is None else sp["counts"].get(whole, 0)
    return 100.0 * num / den if den else None


# ---------------------------------------------------------------- the trace
def _cupti_thread(ident: int) -> int:
    """A pthread id as a CUDA runtime record of the trace carries it (its
    low 32 bits, signed)."""
    return ctypes.c_int32(ident & 0xFFFFFFFF).value


class ProgramSpans(trace.Spans):
    """trace.Spans that, once frozen, also hold each client's program
    spans, so that `at()` names the innermost program span a client was
    in (scan.pools, agg.pull, ...). Each client's thread ids are taken
    when the harness adds its first span, on the client's thread."""

    def __init__(self, n_clients: int):
        super().__init__(n_clients)
        self.threads = [None] * n_clients  # (pthread ident, native id)

    def add(self, client: int, name: str, t0: float, t1: float):
        if self.threads[client] is None:
            self.threads[client] = (threading.get_ident(), threading.get_native_id())
        super().add(client, name, t0, t1)

    def program_spans(self, profiles: list) -> dict:
        """client -> [(start, end, name)] of its closed program spans."""
        native = {ids[1]: c for c, ids in enumerate(self.threads) if ids}
        out = defaultdict(list)
        for p in profiles:
            for sp in p.get("spans", ()):
                c = native.get(sp["thread"])
                if c is not None and sp["end_ns"] is not None:
                    out[c].append((sp["start_ns"] / 1e9, sp["end_ns"] / 1e9, sp["name"]))
        return out

    def freeze(self, profiles: list | None = None):
        spans = self.program_spans(program_profiles() if profiles is None else profiles)
        for c, items in spans.items():
            for t0, t1, name in items:
                super().add(c, name, t0, t1)
        super().freeze()


class LaunchTrace(trace.DeviceTrace):
    """trace.DeviceTrace whose stop() also keeps each kernel's correlation
    id and the CUDA runtime's launch records (host time, the launching
    thread as CUPTI gives it, correlation id), from the same CUDA-only
    profile. The marker kernel runs once before the profiler starts: its
    first call in a process compiles it, which puts that time between the
    host mark and the marker's launch."""

    def __init__(self, device):
        super().__init__(device)
        self.kernels = []   # (name, start, end, correlation id), host clock
        # correlation id -> (host time, CUPTI thread id, seconds in the call)
        self.launches = {}
        self.alignment = {}

    def start(self):
        torch = self.torch
        torch.special.i1e(torch.ones(256, dtype=torch.float64, device=self.device))
        torch.cuda.synchronize(self.device)
        super().start()

    def stop(self) -> list:
        events = super().stop()
        # the profiler's host records are on the wall clock, which the mark
        # read beside the host clock
        wall_minus_host_ns = self.mark_wall_ns - self.mark_host * 1e9
        cuda = self.torch.autograd.DeviceType.CUDA
        raw = list(self.prof.profiler.kineto_results.events())
        marks = [e for e in raw if e.device_type() == cuda and trace.MARKER_OP in e.name()]
        dev_offset = (min(e.start_ns() for e in marks) - self.mark_host * 1e9 if marks
                      else self.mark_wall_ns - self.mark_host * 1e9)
        for e in raw:
            if e.device_type() == cuda:
                if trace.is_kernel(e.name()) and trace.MARKER_OP not in e.name():
                    s = (e.start_ns() - dev_offset) / 1e9
                    self.kernels.append((e.name(), s, s + e.duration_ns() / 1e9,
                                         e.correlation_id()))
            elif "Launch" in e.name() and e.correlation_id():
                self.launches[e.correlation_id()] = (
                    (e.start_ns() - wall_minus_host_ns) / 1e9, e.device_resource_id(),
                    e.duration_ns() / 1e9)
        if marks:
            launch = self.launches.get(marks[0].correlation_id())
            start = (marks[0].start_ns() - wall_minus_host_ns) / 1e9
            self.alignment = {
                "marker_launch_after_mark_us":
                    None if launch is None else (launch[0] - self.mark_host) * 1e6,
                "marker_start_after_mark_us": (start - self.mark_host) * 1e6,
            }
        return events


def attribute(kernels: list, launches: dict, spans: ProgramSpans, profiles: list,
              t0: float, t1: float) -> dict:
    """The kernels in [t0, t1] by the innermost program span open on the
    launching thread when the launch was made: label -> {"device_s": their
    device seconds in the window, "kernels": how many, "launch_s": host
    seconds spent inside their launch calls}. "(no launch record)" where
    the trace has none, "(no program span)" where the thread was in none
    (or is not a client's)."""
    by_thread = {}
    for c, items in spans.program_spans(profiles).items():
        one = trace.Spans(1)
        for s, e, name in items:
            one.add(0, name, s, e)
        one.freeze()
        by_thread[_cupti_thread(spans.threads[c][0])] = one
    out = defaultdict(lambda: {"device_s": 0.0, "kernels": 0, "launch_s": 0.0})
    for _name, s, e, corr in kernels:
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        launch = launches.get(corr)
        if launch is None:
            label = "(no launch record)"
        else:
            one = by_thread.get(launch[1])
            label = one.at(launch[0]) if one is not None else "(no program span)"
            if label == "between queries":
                label = "(no program span)"
        out[label]["device_s"] += e - s
        out[label]["kernels"] += 1
        if launch is not None:
            out[label]["launch_s"] += launch[2]
    return dict(out)
