"""ColumnSegmentCatalog: access statistics + adaptive compaction policy.

Parity with the reference (src/catalog/catalog_entry/column_segment_catalog.cpp,
188 LoC): a registry of every live column segment with a read-access counter,
plus a background thread that periodically compresses the coldest
`compression_rate` fraction of segments and uncompresses the hottest rest,
then decays the counters (the reference zeroes them,
column_segment_catalog.cpp:109-112).

Design fixes over the reference (its known defects, SURVEY.md §2.1):
- the registry is lock-guarded (the reference mutates an unordered_map from
  scan threads while the policy thread iterates it — a data race);
- the policy thread is a daemon with a stop event, not a detached
  while(true) std::thread;
- counters decay (halve) instead of resetting to zero, so the policy keeps
  memory of skew across rounds while still adapting;
- the catalog is per-database, not process-global static state
  (reference catalog.hpp:239 is a static member).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List


class AccessStatistics:
    __slots__ = ("num_reads",)

    def __init__(self):
        self.num_reads = 0


class ColumnSegmentCatalog:
    def __init__(self, config):
        self.config = config
        self._lock = threading.Lock()
        self._segments: List = []  # all live ColumnSegments
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.background_compaction_enabled = False
        self._dict_columns: List = []  # VARCHAR columns (FSST compaction)
        # statistics for introspection / benchmarks
        self.policy_rounds = 0

    # ---------------- registry ----------------
    def add_column_segment(self, segment) -> None:
        with self._lock:
            self._segments.append(segment)

    def remove_column_segment(self, segment) -> None:
        with self._lock:
            try:
                self._segments.remove(segment)
            except ValueError:
                pass

    def segments_snapshot(self) -> List:
        with self._lock:
            return list(self._segments)

    # ---------------- accounting ----------------
    def get_total_data_size(self) -> int:
        """Reference GetTotalDataSize: logical footprint of all segments."""
        return sum(s.footprint_bytes() for s in self.segments_snapshot())

    def print_stats(self) -> str:
        """Reference Print(): per-segment access ratios and sizes."""
        segs = self.segments_snapshot()
        total_reads = sum(s.num_reads for s in segs) or 1
        lines = []
        for s in sorted(segs, key=lambda s: -s.num_reads)[:50]:
            lines.append(
                f"reads={s.num_reads} ({100.0 * s.num_reads / total_reads:.2f}%) "
                f"state={s.state} bytes={s.footprint_bytes()} rows={s.count}"
            )
        return "\n".join(lines)

    # ---------------- policy ----------------
    def compact_all_segments(self) -> None:
        """Reference CompactAllSegments (benchmarks call this after load)."""
        for s in self.segments_snapshot():
            s.compact()
        if getattr(self.config, "fsst_dictionary_enabled", True):
            with self._lock:
                cols = list(self._dict_columns)
            for col in cols:
                col.dictionary.compress_fsst()

    def add_dictionary_column(self, col) -> None:
        """Register a VARCHAR column so dictionary-blob compaction (FSST)
        runs alongside segment compaction."""
        with self._lock:
            self._dict_columns.append(col)

    def compress_lowest_k_segments(self, rate: float | None = None) -> tuple:
        """One adaptive policy step (reference CompressLowestKSegments,
        column_segment_catalog.cpp:64-116): sort by access count ascending,
        compact the coldest `rate` fraction, uncompact the hottest rest.
        Returns (n_compacted, n_uncompacted)."""
        if rate is None:
            rate = self.config.compression_rate
        segs = [s for s in self.segments_snapshot() if s.succinct_possible]
        if not segs:
            return (0, 0)
        segs.sort(key=lambda s: s.num_reads)
        k = int(len(segs) * rate)
        n_c = n_u = 0
        for s in segs[:k]:
            n_c += 1 if s.compact() else 0
        for s in segs[k:]:
            n_u += 1 if s.uncompact() else 0
        # decay counters (reference resets to zero; decay keeps skew memory)
        for s in segs:
            with s._lock:
                s.num_reads >>= 1
        self.policy_rounds += 1
        return (n_c, n_u)

    def enable_background_compaction(self) -> None:
        """Reference EnableBackgroundThreadCompaction: start the policy loop."""
        if self._thread is not None:
            return
        self.background_compaction_enabled = True
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.config.compaction_period_s):
                try:
                    self.compress_lowest_k_segments()
                except Exception:
                    # policy failures must never take down the engine
                    import traceback

                    traceback.print_exc()

        self._thread = threading.Thread(
            target=loop, name="adacom-compaction", daemon=True
        )
        self._thread.start()

    def disable_background_compaction(self) -> None:
        self.background_compaction_enabled = False
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
