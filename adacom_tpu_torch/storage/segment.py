"""ColumnSegment: the unit of storage, compaction, and access tracking.

Port of adacom_tpu/storage/segment.py. Parity with the reference's
ColumnSegment (src/storage/table/column_segment.cpp, 846 LoC): a
fixed-capacity run of one column's rows that flips in place between an
uncompressed and a succinct (bit-packed) representation
(Compact()/Uncompact(), column_segment.cpp:273,324), carries zonemap
min/max statistics, counts read accesses for the adaptive policy, and
reports its footprint to the buffer manager.

In the port:
- residency is torch tensors on the database's device (the buffer
  manager's ``device``); the host copy stays authoritative, so page-out
  drops the tensors and the next access re-uploads (and re-packs);
- Compact() builds the new representation and swaps one reference, so
  concurrent scans keep a consistent snapshot;
- only the succinct codec is ported; the generic codecs of the JAX
  package's ops/codecs.py raise NotImplementedError (ROADMAP queue A).
"""

from __future__ import annotations

import itertools
import threading
from typing import Optional

import numpy as np
import torch

from adacom_tpu_torch import types as tt
from adacom_tpu_torch.ops import bitpack, segcodec

PLAIN = "plain"
PACKED = "packed"

# monotonic segment serials: device caches key on (serial, version), which
# no other segment can ever share (an id() can be reused after GC)
_SERIALS = itertools.count()


def compute_dtype_for(np_dtype: np.dtype) -> np.dtype:
    """Device compute dtype for a storage dtype (ints widen to 32-bit)."""
    if np_dtype.kind == "i":
        return np.dtype(np.int32) if np_dtype.itemsize <= 4 else np.dtype(np.int64)
    if np_dtype.kind == "u":
        return np.dtype(np.uint32) if np_dtype.itemsize <= 4 else np.dtype(np.uint64)
    return np_dtype


class ColumnSegment:
    """A sealed, immutable-content run of rows for one column."""

    def __init__(
        self,
        ltype: tt.LogicalType,
        values: np.ndarray,
        config,
        buffer_manager,
        validity: Optional[np.ndarray] = None,
        start_row: int = 0,
    ):
        self.ltype = ltype
        self.config = config
        self.bm = buffer_manager
        self.device: torch.device = buffer_manager.device
        self.serial = next(_SERIALS)
        self.count = int(values.shape[0])
        self.start_row = start_row
        self.compute_dtype = compute_dtype_for(ltype.np_dtype)
        self._lock = threading.RLock()

        # access statistics (reference AccessStatistics.num_reads);
        # written under self._lock by scans and the policy thread
        self.num_reads = 0

        # validity: None == all rows valid
        self.null_count = 0
        self._validity_np: Optional[np.ndarray] = None
        if validity is not None and not validity.all():
            self._validity_np = np.ascontiguousarray(validity.astype(np.bool_))
            self.null_count = int((~self._validity_np).sum())
            # null slots must not pollute stats/packing: fill with a valid value
            values = values.copy()
            if self.count > self.null_count:
                fill = values[self._validity_np][0]
            else:
                fill = np.zeros((), dtype=values.dtype)
            values[~self._validity_np] = fill

        # zonemap stats over valid rows (host-side numpy, computed once)
        if self.count:
            if ltype.np_dtype.kind in "iu":
                self.vmin = int(values.min())
                self.vmax = int(values.max())
            else:
                self.vmin = float(values.min())
                self.vmax = float(values.max())
        else:
            self.vmin = self.vmax = 0

        # the reference gates succinct on integer types + config
        # (CreateTransientSegment, column_segment.cpp:45-82). VARCHAR
        # segments hold u32 dictionary codes, so FOR-bit-packing them is the
        # reference's dictionary compression — included.
        self.succinct_possible = bool(
            (ltype.integer or ltype.is_string) and config.succinct_enabled)

        # representation (exactly one of these is set when resident)
        self._state = PLAIN
        # codec used when compacted: "succinct"; None while plain
        self.codec: Optional[str] = None
        self._plain: Optional[torch.Tensor] = None
        self._packed: Optional[segcodec.PackedData] = None
        self._validity_dev: Optional[torch.Tensor] = None
        # host copy for page-in (kept in storage dtype: cheapest RAM form)
        self._host_values: np.ndarray = np.ascontiguousarray(values)
        self._paged_out = True  # starts on host; first access uploads

        self.version = 0

    # ------------------------------------------------------------------
    # state & footprint
    # ------------------------------------------------------------------
    @property
    def state(self) -> str:
        return self._state

    def is_compacted(self) -> bool:
        return self._state == PACKED

    def device_nbytes(self) -> int:
        n = 0
        if self._plain is not None:
            n += self._plain.numel() * self._plain.element_size()
        if self._packed is not None:
            n += self._packed.nbytes
        if self._validity_dev is not None:
            n += self._validity_dev.numel() * 4
        return n

    def footprint_bytes(self) -> int:
        """Logical data footprint (reference GetDataSize accounting):
        packed bytes when compacted, plain bytes otherwise. Valid whether or
        not the segment is device-resident."""
        if self._state == PACKED:
            if self._packed is not None:
                return self._packed.nbytes
            widths, _ = segcodec.plan_widths(
                self.vmin, self.vmax, self.compute_dtype.itemsize,
                extract_prefix=self.config.succinct_extract_prefix_enabled,
                padded_to_byte=self.config.succinct_padded_to_next_byte_enabled,
            )
            return segcodec.packed_nbytes(widths, bitpack.lanes_for(self.count))
        return self.count * self.compute_dtype.itemsize

    # ------------------------------------------------------------------
    # residency
    # ------------------------------------------------------------------
    def _upload(self) -> torch.Tensor:
        """Host values -> a compute-dtype tensor on the segment's device."""
        return torch.from_numpy(self._host_compute_values()).to(self.device)

    def _ensure_resident(self) -> None:
        with self._lock:
            if not self._paged_out:
                self.bm.touch(self)
                return
            arr = self._upload()
            if self._validity_np is not None:
                # width-1 pack the validity bitmap on the device
                bits = torch.from_numpy(self._validity_np).to(self.device)
                self._validity_dev = bitpack.pack(
                    bitpack.pad_codes(bits, bitpack.lanes_for(self.count)), width=1
                )
            if self._state == PACKED:
                self._packed = self._pack_from(arr)
                self._plain = None
            else:
                self._plain = arr
                self._packed = None
            self._paged_out = False
            self.bm.notify_alloc(self, self.device_nbytes())

    def try_page_out(self) -> int:
        """Non-blocking page_out for the buffer manager's eviction sweep
        (avoids lock-order inversion with segments busy elsewhere)."""
        if not self._lock.acquire(blocking=False):
            return 0
        try:
            return self._page_out_locked()
        finally:
            self._lock.release()

    def page_out(self) -> int:
        """Drop device residency (host copy is authoritative). Returns bytes
        freed; called by the buffer manager under memory pressure."""
        with self._lock:
            return self._page_out_locked()

    def _page_out_locked(self) -> int:
        if self._paged_out:
            return 0
        freed = self.device_nbytes()
        self._plain = None
        self._packed = None
        self._validity_dev = None
        self._paged_out = True
        self.version += 1
        return freed

    # ------------------------------------------------------------------
    # compaction state machine (reference Compact()/Uncompact())
    # ------------------------------------------------------------------
    def _pack_from(self, arr: torch.Tensor) -> segcodec.PackedData:
        return segcodec.pack_segment(
            arr,
            self.ltype,
            extract_prefix=self.config.succinct_extract_prefix_enabled,
            padded_to_byte=self.config.succinct_padded_to_next_byte_enabled,
            vmin=self.vmin if isinstance(self.vmin, int) else None,
            vmax=self.vmax if isinstance(self.vmax, int) else None,
        )

    def _host_compute_values(self) -> np.ndarray:
        return self._host_values.astype(self.compute_dtype, copy=False)

    def _resolve_codec(self, codec: Optional[str]) -> Optional[str]:
        """Pick the compaction codec: explicit arg > force_compression >
        config.compression_codec. Only "succinct" and "uncompressed" are
        ported."""
        if codec is None:
            codec = self.config.force_compression
        if codec is None:
            codec = getattr(self.config, "compression_codec", "succinct")
        codec = codec.lower()
        if codec == "succinct":
            return "succinct" if self.succinct_possible else None
        if codec == "uncompressed":
            return None
        raise NotImplementedError(
            f"compression codec {codec!r} is not ported yet (ROADMAP queue "
            f"A, generic device path: ops/codecs.py)")

    def compact(self, codec: Optional[str] = None) -> bool:
        """Compress in place. Returns True if the state changed.

        Reference Compact() (column_segment.cpp:273) bit-compresses
        succinct. A paged-out segment only flips its state: packing happens
        at the next access (the first scan after load packs every segment)."""
        if self.count == 0:
            return False
        with self._lock:
            if self._state == PACKED:
                return False
            resolved = self._resolve_codec(codec)
            if resolved is None:
                return False
            before = self.footprint_bytes()
            self.codec = resolved
            if self._paged_out:
                self._state = PACKED  # materializes on page-in
            else:
                old_bytes = self.device_nbytes()
                arr = self._plain
                if arr is None:
                    arr = self._upload()
                self._packed = self._pack_from(arr)
                self._plain = None
                self._state = PACKED
                self.bm.notify_free(self, old_bytes)
                self.bm.notify_alloc(self, self.device_nbytes())
            self.version += 1
            self.bm.add_to_data_size(self.footprint_bytes() - before)
            return True

    def uncompact(self) -> bool:
        """Restore the uncompressed representation (hot segments)."""
        with self._lock:
            if self._state == PLAIN:
                return False
            before = self.footprint_bytes()
            if self._paged_out:
                self._state = PLAIN
            else:
                old_bytes = self.device_nbytes()
                self._plain = segcodec.unpack_segment(
                    self._packed, self.compute_dtype)
                self._packed = None
                self._state = PLAIN
                self.bm.notify_free(self, old_bytes)
                self.bm.notify_alloc(self, self.device_nbytes())
            self.codec = None
            self.version += 1
            self.bm.add_to_data_size(self.footprint_bytes() - before)
            return True

    # ------------------------------------------------------------------
    # scan interface
    # ------------------------------------------------------------------
    def add_read_access(self) -> None:
        """Reference ColumnSegmentCatalog::AddReadAccess (called per scan).

        Incremented under the segment lock: the policy thread's decay
        (segment_catalog.CompressLowestKSegments) writes the same field."""
        with self._lock:
            self.num_reads += 1

    def reader_arrays(self):
        """Snapshot for fused execution: (meta, device tensors).

        Packed: (("packed", (widths, n_lanes, dtype)), words of the
        non-constant planes). Plain: (("plain", dtype, count), (values,))."""
        self._ensure_resident()
        self.add_read_access()
        with self._lock:
            if self._state == PACKED:
                p = self._packed
                return ("packed", p.meta), tuple(
                    w for w in p.words if w is not None)
            arr = self._plain
            return ("plain", str(self.compute_dtype), int(arr.shape[0])), (arr,)

    def packed(self) -> Optional[segcodec.PackedData]:
        """The resident PackedData (None unless compacted)."""
        self._ensure_resident()
        return self._packed

    def validity_arrays(self):
        """Packed validity words for fused kernels; None when all valid."""
        if self._validity_np is None:
            return None
        self._ensure_resident()
        return (self._validity_dev,)

    def host_plain(self) -> np.ndarray:
        """Host copy in compute dtype — the latency tier for selective point
        lookups (a device roundtrip costs more than a SIMD scan of one
        segment). Counts as a read access for the adaptive policy."""
        self.add_read_access()
        return self._host_compute_values()

    def host_validity(self) -> Optional[np.ndarray]:
        return self._validity_np

    # zonemap check (reference CheckZonemapSegments, row_group.cpp:287)
    def zonemap_may_match(self, op: str, value) -> bool:
        if self.count == 0:
            return False
        try:
            if op == "=":
                return self.vmin <= value <= self.vmax
            if op in ("<", "<="):
                return self.vmin < value or (op == "<=" and self.vmin <= value)
            if op in (">", ">="):
                return self.vmax > value or (op == ">=" and self.vmax >= value)
        except TypeError:
            return True
        return True

    def __repr__(self):
        return (
            f"<Segment {self.ltype} rows={self.count} state={self._state} "
            f"reads={self.num_reads} bytes={self.footprint_bytes()}>"
        )
