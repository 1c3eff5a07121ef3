"""Spans and counters of one statement, recorded while profiling is on
(PRAGMA enable_profiling, config.enable_profiling).

`Connection` makes a `StatementTrace` for each statement it runs while
profiling is on and hangs it on its executor as `executor.trace`. With
profiling off `executor.trace` is None, and a span site is one `is None`
test: no clock is read, nothing is allocated and nothing is called.

A span is a dict:

- `name`: one of the fixed names that README.md lists (`query`, `plan`,
  `execute`, `op.<Operator>`, `scan.snapshot`, `scan.pools`, `scan.stack`,
  `scan.decode`, `scan.filter`, `scan.host`, `agg.partials`, `agg.pull`,
  `agg.finish`, `agg.fused`, `subquery`, `join.build`, `join.probe`);
- `id`, `parent`: its index in the statement's spans, and the index of the
  span that was open when it began (None for the statement's root);
- `query_id`: the connection's token and the statement's number on the
  connection, `"<token>.<n>"`, the same on every span of a statement;
- `thread`: `threading.get_native_id()`, the OS thread id;
- `start_ns`, `end_ns`: `time.perf_counter_ns()` (CLOCK_MONOTONIC);
- `cpu_start_ns`, `cpu_end_ns`: the thread's CPU time,
  `time.thread_time_ns()`; wall minus CPU time is time off the CPU;
- `counts`: a small dict of counts (rows, segments, hits, bytes, ...);
- operator spans also carry `node`, the id() of their plan node.

Spans are recorded on the thread that runs the statement; a span begun on
another thread (a scan morsel on the task scheduler) is not recorded. The
statement's spans and counters are handed out as
`Connection.last_profile["spans"]` and `["counters"]`, and its profile is
kept among the process's latest (`recent()`), for a reader that holds no
connection."""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional

# the clocks every span reads (a test replaces them to show that a
# statement run with profiling off reads neither)
clock = time.perf_counter_ns
cpu_clock = time.thread_time_ns

# profiles of the process's latest profiled statements, oldest first
RECENT_LIMIT = 4096
_recent: "collections.deque[dict]" = collections.deque(maxlen=RECENT_LIMIT)


def keep(profile: dict) -> None:
    _recent.append(profile)


def recent() -> List[dict]:
    """The profiles (as `Connection.last_profile` holds them) of the last
    RECENT_LIMIT statements that ran with profiling on in this process,
    from every connection, oldest first."""
    return list(_recent)


class StatementTrace:
    """The spans and counters of one statement (see the module's
    docstring). `counters["lock_wait_ns"]` sums the time spent acquiring
    the locks a statement takes once: the buffer manager's in
    begin_statement, the plan cache's and each scanned table's append
    lock in read_snapshot."""

    def __init__(self, query_id: str):
        self.query_id = query_id
        self.thread = threading.get_native_id()
        self.spans: List[dict] = []
        self.counters: Dict[str, int] = {"lock_wait_ns": 0}
        # the plan tree with per-operator times, for the statement's profile
        self.operators: Optional[str] = None
        self._open: List[int] = []  # ids of the open spans, innermost last

    def begin(self, name: str, node: Optional[int] = None) -> Optional[dict]:
        """Open a span inside the innermost open one; None on a thread
        other than the statement's."""
        if threading.get_native_id() != self.thread:
            return None
        sp = {"name": name, "id": len(self.spans),
              "parent": self._open[-1] if self._open else None,
              "query_id": self.query_id, "thread": self.thread,
              "start_ns": clock(), "end_ns": None,
              "cpu_start_ns": cpu_clock(), "cpu_end_ns": None, "counts": {}}
        if node is not None:
            sp["node"] = node
        self.spans.append(sp)
        self._open.append(sp["id"])
        return sp

    def end(self, sp: dict, **counts) -> None:
        """Close `sp`, with `counts` added to its counts. Spans still open
        inside it (an exception passed their end) close with it."""
        if sp["end_ns"] is None:
            # the CPU interval inside the wall one: begin reads the wall
            # clock first, end last, so CPU time never exceeds wall time
            c = cpu_clock()
            t = clock()
            while self._open:
                inner = self.spans[self._open.pop()]
                inner["end_ns"], inner["cpu_end_ns"] = t, c
                if inner is sp:
                    break
        sp["counts"].update(counts)

    def set(self, **counts) -> None:
        """Counts onto the innermost open span."""
        if self._open:
            self.spans[self._open[-1]]["counts"].update(counts)

    def timed(self, lock) -> "_TimedLock":
        """`lock` as a context manager that adds the time spent acquiring
        it to the innermost open span's and the statement's lock_wait_ns."""
        return _TimedLock(self, lock)


class _TimedLock:
    __slots__ = ("trace", "lock")

    def __init__(self, trace: StatementTrace, lock):
        self.trace, self.lock = trace, lock

    def __enter__(self):
        t = clock()
        self.lock.acquire()
        waited = clock() - t
        tr = self.trace
        tr.counters["lock_wait_ns"] += waited
        if tr._open:
            counts = tr.spans[tr._open[-1]]["counts"]
            counts["lock_wait_ns"] = counts.get("lock_wait_ns", 0) + waited
        return self

    def __exit__(self, *exc):
        self.lock.release()
        return False


def seconds(sp: dict) -> float:
    return (sp["end_ns"] - sp["start_ns"]) / 1e9


def phases(spans: List[dict], root: dict) -> Dict[str, float]:
    """plan_s and execute_s of a SELECT: its root's `plan` and `execute`
    children."""
    out = {}
    for sp in spans:
        if sp["parent"] == root["id"] and sp["name"] in ("plan", "execute"):
            out.setdefault(f"{sp['name']}_s", seconds(sp))
    return out


def operator_profile(spans: List[dict], since: int = 0) -> Dict[int, tuple]:
    """id(plan node) -> (inclusive seconds, rows out) from the operator
    spans from index `since` on, summed where a node ran again (a
    subquery): what the rendered plan and EXPLAIN ANALYZE show."""
    out: Dict[int, tuple] = {}
    for sp in spans[since:]:
        node = sp.get("node")
        if node is None or sp["end_ns"] is None:
            continue
        dt, rows = seconds(sp), sp["counts"].get("rows", 0)
        prev = out.get(node)
        out[node] = (dt, rows) if prev is None else (prev[0] + dt, prev[1] + rows)
    return out
