"""Buffer manager: device memory accounting, limits, and spill.

Parity with the reference BufferManager (src/storage/buffer_manager.cpp):
Pin/Unpin becomes device-residency management — segments register their HBM
footprint; when a PRAGMA memory_limit is set and exceeded, the coldest
unpinned segments are *paged out* to host RAM (the TPU analogue of the
reference's temp-file spill) and transparently re-uploaded on next access.
Also carries the AdaCom `data_size` counter used by the succinct benchmarks
(buffer_manager.hpp:71-83 AddToDataSize/GetDataSize).
"""

from __future__ import annotations

import threading
from typing import Optional


class OutOfMemoryError(RuntimeError):
    pass


class BufferManager:
    def __init__(self, config, device):
        self.config = config
        # the torch device that holds every resident segment
        self.device = device
        self._lock = threading.RLock()
        # bytes currently resident on device
        self.device_bytes = 0
        # AdaCom logical data-size counter (compressed footprint accounting)
        self.data_size = 0
        # LRU of resident evictable segments: segment -> tick
        self._resident: dict = {}
        self._tick = 0

    # --- AdaCom data-size accounting (reference AddToDataSize) ---------
    def add_to_data_size(self, delta: int) -> None:
        with self._lock:
            self.data_size += delta

    def get_data_size(self) -> int:
        return self.data_size

    # --- device residency ----------------------------------------------
    @property
    def memory_limit(self) -> Optional[int]:
        return self.config.memory_limit

    def notify_alloc(self, segment, nbytes: int) -> None:
        """A segment placed `nbytes` on device. May trigger eviction."""
        with self._lock:
            self.device_bytes += nbytes
            self._tick += 1
            self._resident[segment] = self._tick
            self._maybe_evict(exclude=segment)

    def notify_free(self, segment, nbytes: int) -> None:
        with self._lock:
            self.device_bytes -= nbytes
            self._resident.pop(segment, None)

    def touch(self, segment) -> None:
        with self._lock:
            if segment in self._resident:
                self._tick += 1
                self._resident[segment] = self._tick

    def _maybe_evict(self, exclude=None) -> None:
        limit = self.memory_limit
        if limit is None or self.device_bytes <= limit:
            return
        # Evict least-recently-used segments until under the limit.
        # try_page_out uses a non-blocking lock acquire: a segment busy in
        # compact()/scan on another thread is skipped, avoiding lock-order
        # inversion (segment lock -> bm lock vs bm lock -> segment lock).
        for seg, _ in sorted(self._resident.items(), key=lambda kv: kv[1]):
            if seg is exclude:
                continue
            if self.device_bytes <= limit:
                break
            freed = seg.try_page_out()
            if freed:
                self.device_bytes -= freed
                self._resident.pop(seg, None)
        if self.device_bytes > limit * 1.5:
            # even after evicting everything evictable we are far over limit
            raise OutOfMemoryError(
                f"device memory {self.device_bytes}B exceeds limit {limit}B"
            )
