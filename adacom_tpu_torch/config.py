"""Engine configuration (port of adacom_tpu/config.py).

Typed equivalent of the reference's DBConfig flags
(src/include/duckdb/main/config.hpp:189-197), which there are C++-only;
here every knob is a dataclass field AND settable through SQL
(``SET succinct_enabled = false`` / ``PRAGMA memory_limit='1GB'``),
fixing the reference's gap (flags not registered in settings.cpp).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class DBConfig:
    # --- AdaCom codec policy (reference config.hpp:189-197) ---
    # Master switch: integer segments are born succinct-eligible.
    succinct_enabled: bool = True
    # Frame-of-reference: subtract the per-segment minimum before packing.
    succinct_extract_prefix_enabled: bool = True
    # Round the packed bit width up to the next multiple of 8.
    succinct_padded_to_next_byte_enabled: bool = False
    # Adaptive mode: segments are born plain and a background policy
    # compresses cold ones; non-adaptive mode compacts eagerly on first scan
    # (reference column_segment.cpp:154-188).
    adaptive_succinct_compression_enabled: bool = False

    # --- Adaptive policy knobs (reference hard-codes 10 s / 0.9:
    #     column_segment_catalog.cpp:64-116) ---
    compaction_period_s: float = 10.0
    compression_rate: float = 0.9

    # --- Engine ---
    # Rows per column segment. Power of two, multiple of the 8x128 VPU tile
    # and of the 32-row packing group (reference: 122880-row row groups x
    # 256 KiB blocks, storage_info.hpp:18).
    segment_rows: int = 1 << 16
    # Buffer-manager memory limit in bytes (PRAGMA memory_limit). None =
    # unlimited. (reference buffer_manager.cpp SetLimit)
    memory_limit: Optional[int] = None
    # Worker threads for host-side orchestration (PRAGMA threads).
    threads: int = 0  # 0 = auto
    # Force a compression codec at compaction/checkpoint ("uncompressed" |
    # "succinct" | any registry codec: rle/delta/dictionary/constant/alp).
    force_compression: Optional[str] = None
    # Default compaction codec: "succinct" (reference Compact() parity) or
    # "auto" (checkpoint-style analyze-based best-codec selection,
    # DetectBestCompressionMethod parity) or a specific codec name.
    compression_codec: str = "succinct"
    # torch device that holds resident segments and runs the fused scan:
    # "cuda" or "cpu". Database() resolves it once; "cuda" without a card
    # raises instead of running on the CPU.
    platform: str = "cuda"
    # Fused table-scan kernel (ops/fused_scan.py) for eligible aggregate
    # scans (single packed 4-byte plane, range predicate,
    # sum/count/min/max). Ineligible aggregates take the host tier. The
    # name matches the JAX package's knob so the SQL surface is the same.
    pallas_scan_enabled: bool = True
    # The cost-routing knobs device_agg_min_rows, host_scan_segment_limit
    # and host_materialize keep the JAX package's names and values so the
    # SQL surface matches; the port's first slice reads none of them (it
    # scans on the host and aggregates on the device or the host by query
    # shape alone) and they are re-derived on the GPU as the device tiers
    # arrive (ROADMAP).
    device_agg_min_rows: int = 32_000_000
    # Fold the aggregate sink into the streamed join probe pipeline
    # (scan -> probe -> partial-agg per morsel; the joined intermediate
    # never materializes). Requires streaming_join_enabled.
    streaming_agg_sink_enabled: bool = True
    # Adaptive auto-indexing: after this many selective equality probes on
    # an un-indexed column whose zonemaps can't prune (interleaved key
    # distributions, e.g. the FBWorkload prefix-random u64 trace), the
    # latency tier builds an in-memory SortedIndex for it automatically —
    # the access-counter-driven adaptivity of the segment catalog applied
    # to lookups. 0 disables. Auto indexes are never persisted.
    auto_index_threshold: int = 64
    # Multi-device joins (not ported): equi-joins at or above this row
    # count shuffle across devices; smaller joins stay on the host.
    distributed_join_rows: int = 1 << 15
    host_scan_segment_limit: int = 4
    host_materialize: bool = True
    # Pipelined probe execution: base-table probe sides stream morsel-by-
    # morsel through a persistent native hash table instead of fully
    # materializing (reference pipeline_executor.cpp push loop).
    streaming_join_enabled: bool = True
    # Index join: when the probe side has at most this many rows and the
    # build side is an indexed base table at least 4x larger, probe the
    # index instead of scanning (reference physical_index_join.cpp).
    # 0 disables.
    index_join_max_probe: int = 8192
    # Compact cold VARCHAR dictionaries with the native FSST-class codec
    # when segments compact (reference fsst.cpp; adopted only when the
    # encoding actually shrinks the blob).
    fsst_dictionary_enabled: bool = True
    # WAL size (bytes) that triggers an automatic checkpoint; None disables
    # (reference checkpoint-on-threshold; PRAGMA wal_autocheckpoint).
    wal_autocheckpoint: Optional[int] = 64 * 1024 * 1024
    # Fault injection: abort checkpoints at the named stage
    # ("none" | "before_header"), reference PRAGMA debug_checkpoint_abort.
    checkpoint_abort: str = "none"
    # Enable per-query profiling (PRAGMA enable_profiling).
    enable_profiling: bool = False
    # Statement verification: re-run each SELECT unoptimized and compare
    # (reference src/verification/statement_verifier.hpp).
    query_verification_enabled: bool = False

    def copy(self) -> "DBConfig":
        return dataclasses.replace(self)

    # SQL `SET key = value` support -------------------------------------
    _BOOL_KEYS = frozenset(
        {
            "succinct_enabled",
            "succinct_extract_prefix_enabled",
            "succinct_padded_to_next_byte_enabled",
            "adaptive_succinct_compression_enabled",
            "enable_profiling",
            "query_verification_enabled",
            "host_materialize",
            "pallas_scan_enabled",
            "fsst_dictionary_enabled",
            "streaming_join_enabled",
            "streaming_agg_sink_enabled",
        }
    )

    def set_option(self, key: str, value) -> None:
        key = key.lower()
        if key in self._BOOL_KEYS:
            setattr(self, key, _as_bool(value))
        elif key in ("compaction_period_s", "compression_rate"):
            setattr(self, key, float(value))
        elif key == "memory_limit":
            self.memory_limit = parse_memory_limit(value)
        elif key == "wal_autocheckpoint":
            self.wal_autocheckpoint = parse_memory_limit(value)
        elif key in ("checkpoint_abort", "debug_checkpoint_abort"):
            v = str(value).strip("'\"").lower()
            if v not in ("none", "before_header"):
                raise ValueError(f"unknown checkpoint_abort stage: {v}")
            self.checkpoint_abort = v
        elif key == "threads":
            self.threads = int(value)
            from adacom_tpu_torch.parallel.scheduler import TaskScheduler

            TaskScheduler.get().set_threads(self.threads)
        elif key == "force_compression":
            v = str(value).strip("'\"").lower()
            self.force_compression = None if v in ("", "auto", "none") else v
        elif key == "compression_codec":
            v = str(value).strip("'\"").lower() or "succinct"
            if v not in ("succinct", "auto", "uncompressed"):
                # the generic codec registry is not ported yet
                from adacom_tpu_torch.ops import codecs as _codecs
                if v not in _codecs.REGISTRY:
                    raise ValueError(f"unknown compression codec: {v}")
            self.compression_codec = v
        elif key in ("host_scan_segment_limit", "distributed_join_rows",
                     "index_join_max_probe", "auto_index_threshold",
                     "device_agg_min_rows"):
            setattr(self, key, int(value))
        elif key == "segment_rows":
            n = int(value)
            if n <= 0 or n % 1024:
                raise ValueError("segment_rows must be a positive multiple of 1024")
            self.segment_rows = n
        else:
            raise KeyError(f"unknown setting: {key}")


def _as_bool(value) -> bool:
    if isinstance(value, bool):
        return value
    s = str(value).strip("'\"").lower()
    if s in ("true", "1", "on", "yes"):
        return True
    if s in ("false", "0", "off", "no"):
        return False
    raise ValueError(f"not a boolean: {value!r}")


_UNITS = {
    "b": 1,
    "kb": 1000,
    "mb": 1000**2,
    "gb": 1000**3,
    "tb": 1000**4,
    "kib": 1024,
    "mib": 1024**2,
    "gib": 1024**3,
}


def parse_memory_limit(value) -> Optional[int]:
    """Parse '1GB' style limits (reference PRAGMA memory_limit)."""
    if value is None:
        return None
    if isinstance(value, (int, float)):
        return int(value)
    s = str(value).strip().strip("'\"").lower().replace(" ", "")
    if s in ("none", "unlimited", "-1", ""):
        return None
    for unit in sorted(_UNITS, key=len, reverse=True):
        if s.endswith(unit):
            return int(float(s[: -len(unit)]) * _UNITS[unit])
    return int(float(s))
