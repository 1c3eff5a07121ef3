"""Spans of the benchmark's own calls into the program, and the reduction
of the device trace (torch.profiler, CUDA activity) to busy time, kernel
counts, the device operations that took most time and the longest idle
gaps, each labelled by the spans the clients were in.

Spans are kept in memory per client; the trace is read from the profiler
in memory and never written to disk."""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

MARKER_OP = "i1e"  # the kernel that marks the window's start on the device


class Spans:
    """(start, end, name) per client, host clock (perf_counter seconds);
    `freeze()` indexes them by start time before `at()` is asked."""

    def __init__(self, n_clients: int):
        self.by_client = [[] for _ in range(n_clients)]

    def add(self, client: int, name: str, t0: float, t1: float):
        self.by_client[client].append((t0, t1, name))

    def freeze(self):
        for spans in self.by_client:
            spans.sort()
        self._starts = [[s[0] for s in spans] for spans in self.by_client]
        self._longest = [max((s[1] - s[0] for s in spans), default=0.0)
                         for spans in self.by_client]

    def at(self, t: float) -> str:
        """The innermost span each client was in at host time t, joined."""
        names = []
        for spans, starts, longest in zip(self.by_client, self._starts, self._longest):
            hi = bisect.bisect_right(starts, t)
            lo = bisect.bisect_left(starts, t - longest)
            best = None
            for t0, t1, name in spans[lo:hi]:
                if t0 <= t <= t1 and (best is None or t1 - t0 < best[1] - best[0]):
                    best = (t0, t1, name)
            names.append(best[2] if best else "between queries")
        return "+".join(sorted(set(names)))


def union(intervals):
    """Disjoint, sorted cover of [(start, end)]."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def reduce_events(events, t0: float, t1: float, spans: Spans, top: int = 10) -> dict:
    """events: [(name, start, end)] on the device in host-clock seconds.
    Returns the summary of the window [t0, t1]."""
    clipped = [(n, max(s, t0), min(e, t1)) for n, s, e in events if e > t0 and s < t1]
    busy = union([(s, e) for _, s, e in clipped])
    busy_s = sum(e - s for s, e in busy)
    by_name = defaultdict(float)
    kernels = 0
    for n, s, e in clipped:
        by_name[n] += e - s
        kernels += is_kernel(n)
    gaps, prev = [], t0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1 > prev:
        gaps.append((prev, t1))
    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "window_s": t1 - t0,
        "busy_s": busy_s,
        "kernels": kernels,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        "idle_gaps": [[spans.at((s + e) / 2), e - s] for s, e in gaps[:top]],
    }


class DeviceTrace:
    """torch.profiler over the window, CUDA activity only."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.device = device
        self.prof = None
        self.mark_host = None
        self.mark_wall_ns = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()

    def mark(self) -> float:
        """Launch the marker kernel; returns the host time it was sent."""
        x = self.torch.ones(256, dtype=self.torch.float64, device=self.device)
        self.mark_wall_ns = time.time_ns()
        self.mark_host = time.perf_counter()
        self.torch.special.i1e(x)
        return self.mark_host

    def stop(self) -> list:
        """Stops the profiler; returns the device events in host-clock
        seconds, aligned by the marker kernel (by the wall clock where the
        trace lacks it)."""
        self.torch.cuda.synchronize(self.device)
        self.prof.stop()
        raw = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != self.torch.autograd.DeviceType.CUDA:
                continue
            raw.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
        marks = [s for n, s, _ in raw if MARKER_OP in n]
        if marks:
            offset_ns = min(marks) - self.mark_host * 1e9
        else:
            offset_ns = self.mark_wall_ns - self.mark_host * 1e9
        self.aligned_by_marker = bool(marks)
        return [(n, (s - offset_ns) / 1e9, (e - offset_ns) / 1e9)
                for n, s, e in raw if MARKER_OP not in n]
