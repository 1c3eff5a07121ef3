"""Database instance (reference DuckDB/DatabaseInstance, src/main/database.cpp):
owns config, device, buffer manager, catalog and plan cache.

Port of adacom_tpu/main/database.py. The torch device is resolved once,
from ``config.platform``; every tensor the engine creates is placed there
explicitly. Only in-memory databases (``path=None``, the reference's
:memory: mode used by all succinct benchmarks) are ported: the WAL and
checkpoint layers come later (ROADMAP queue A, durability)."""

from __future__ import annotations

import threading
from typing import Optional

import torch

from adacom_tpu_torch.config import DBConfig
from adacom_tpu_torch.catalog.catalog import Catalog
from adacom_tpu_torch.storage.buffer import BufferManager


def resolve_device(platform: str) -> torch.device:
    """torch.device for a platform name; "cuda" without a card raises."""
    dev = torch.device(platform)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "platform 'cuda' requested but torch finds no CUDA device "
            "(use platform='cpu' to run on the host)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported platform {platform!r}")
    return dev


class Database:
    def __init__(self, path: Optional[str] = None,
                 config: Optional[DBConfig] = None,
                 platform: Optional[str] = None):
        if path is not None:
            raise NotImplementedError(
                "durable databases (WAL + checkpoint) are not ported yet; "
                "use path=None")
        self.path = None
        # engine event counters (the host scan records auto-index builds)
        self.dist_stats = {"scan_agg": 0, "join": 0, "topk": 0}
        self.config = config or DBConfig()
        if platform is not None:
            self.config.platform = platform
        self.device = resolve_device(self.config.platform)
        self.buffer_manager = BufferManager(self.config, self.device)
        self.catalog = Catalog(self.config, self.buffer_manager)
        # plan cache: template key -> (statements, bound plan, meta)
        self.plan_cache: dict = {}
        self.plan_cache_lock = threading.Lock()
        # template -> structural slot set learned at first bind (binder-baked
        # literals widen the plan-cache key; remembering the widened set per
        # template lets later lookups build the FULL key up front instead of
        # rebinding every execution)
        self.template_slots: dict = {}
        # raw SQL text -> parse() output (hot repeated lookups skip parsing)
        self.parse_cache: dict = {}
        self._closed = False
        self.wal = None

    def connect(self) -> "Connection":
        from adacom_tpu_torch.main.connection import Connection

        return Connection(self)

    def cursor(self) -> "Connection":
        return self.connect()

    def checkpoint(self) -> None:
        """In-memory databases have nothing to checkpoint."""

    def maybe_autocheckpoint(self) -> None:
        """In-memory databases have no WAL to checkpoint."""

    def close(self) -> None:
        if self._closed:
            return
        self.catalog.shutdown()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
