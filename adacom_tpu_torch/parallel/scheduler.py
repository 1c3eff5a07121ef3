"""Host task scheduler: the morsel-driven parallelism analogue.

Parity with the reference's parallel runtime (src/parallel/): there,
`TaskScheduler::ExecuteForever` runs N OS worker threads over a lock-free
queue (task_scheduler.cpp:127) and sources hand out one row group per task
(`NextParallelScan`, row_group_collection.cpp:112). Here the *device* side
is parallelized by XLA (one fused kernel spans a whole segment), so the
scheduler's job is the host tier: per-segment numpy filter evaluation,
page-in staging, and CSV chunk parsing — all of which release the GIL.

A "morsel" is one sealed segment (the row-group analogue). `map_segments`
preserves input order, propagates the first exception, and degrades to the
serial loop for small candidate sets (threading overhead beats the win
below a few morsels) or when `threads == 1`.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, TypeVar

T = TypeVar("T")
R = TypeVar("R")

#: below this many morsels the serial loop wins (dispatch overhead)
MIN_PARALLEL_MORSELS = 4


class TaskScheduler:
    """Process-wide worker pool (reference: one TaskScheduler per database,
    task_scheduler.cpp; thread count = PRAGMA threads, 0 = hw concurrency)."""

    _instance: Optional["TaskScheduler"] = None
    _instance_lock = threading.Lock()

    def __init__(self, n_threads: int = 0):
        self.n_threads = n_threads or min(16, os.cpu_count() or 4)
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pool_lock = threading.Lock()

    @classmethod
    def get(cls) -> "TaskScheduler":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = TaskScheduler()
            return cls._instance

    def _ensure_pool(self) -> ThreadPoolExecutor:
        with self._pool_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.n_threads,
                    thread_name_prefix="adacom-worker")
            return self._pool

    def set_threads(self, n: int) -> None:
        with self._pool_lock:
            if self._pool is not None and (n or 0) != self.n_threads:
                self._pool.shutdown(wait=False)
                self._pool = None
            self.n_threads = n or min(16, os.cpu_count() or 4)

    def map_segments(self, fn: Callable[[T], R], items: Sequence[T],
                     threads: int = 0) -> List[R]:
        """Order-preserving parallel map over morsels."""
        n_workers = threads or self.n_threads
        if len(items) < MIN_PARALLEL_MORSELS or n_workers <= 1:
            return [fn(x) for x in items]
        pool = self._ensure_pool()
        return list(pool.map(fn, items))

    def shutdown(self) -> None:
        with self._pool_lock:
            if self._pool is not None:
                self._pool.shutdown(wait=False)
                self._pool = None
