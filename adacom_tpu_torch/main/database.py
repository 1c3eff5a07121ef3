"""Database instance (reference DuckDB/DatabaseInstance, src/main/database.cpp):
owns config, device, buffer manager, catalog, plan cache and WAL.

Port of adacom_tpu/main/database.py. The torch device is resolved once,
from ``config.platform``; every tensor the engine creates is placed there
explicitly.

Durability (reference SingleFileStorageManager + WAL): a durable database
is a directory holding versioned checkpoint subdirectories published
through a ``CURRENT`` pointer file (so an aborted checkpoint never corrupts
the previous one — the reference's double-buffered database header) plus
``wal.log`` replayed on open. The layout and both file formats are the JAX
package's: either package opens a directory the other wrote."""

from __future__ import annotations

import os
import shutil
import threading
from typing import Optional

import torch

from adacom_tpu_torch.config import DBConfig
from adacom_tpu_torch.catalog.catalog import Catalog
from adacom_tpu_torch.storage.buffer import BufferManager
from adacom_tpu_torch.utils.warmup import warm_in_background


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


class CheckpointAbort(Exception):
    """Injected mid-checkpoint failure (reference PRAGMA
    debug_checkpoint_abort, test/sql/storage/checkpoint_abort*)."""


class Database:
    def __init__(self, path: Optional[str] = None,
                 config: Optional[DBConfig] = None,
                 platform: Optional[str] = None, mesh=None):
        # path: checkpoint directory for persistence (None = in-memory,
        # like the reference's :memory: mode used by all succinct benchmarks)
        self.path = path
        # engine event counters: the host scan records auto-index builds,
        # the mesh paths their distributed scan-aggregates and joins
        self.dist_stats = {"scan_agg": 0, "join": 0, "topk": 0}
        self.config = config or DBConfig()
        if platform is not None:
            self.config.platform = platform
        self.device = resolve_device(self.config.platform)
        # the CUDA context and the kernel library load on a thread, so that
        # no query pays for them (nothing on the CPU)
        warm_in_background(self.device)
        # mesh: a parallel.mesh.Mesh of the database's device type; with
        # one, scan-aggregates and large joins run over its shards
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(
                f"a mesh of {mesh.device_type} devices on a "
                f"{self.device.type} database")
        self.mesh = mesh
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
        # PRAGMA tpu_profile_start/stop: the running torch.profiler and the
        # directory its trace goes to
        self._profiler = None
        self._trace_dir: Optional[str] = None
        self.wal = None
        self._ckpt_seq = 0
        if path is not None:
            from adacom_tpu_torch.storage import wal as walmod
            from adacom_tpu_torch.storage.checkpoint import try_load_database

            os.makedirs(path, exist_ok=True)
            current = self._read_current()
            if current is not None:
                self._ckpt_seq = int(current.rsplit("-", 1)[-1])
                try_load_database(self, os.path.join(path, current))
            else:
                # legacy layout: manifest directly in the directory
                try_load_database(self, path)
            walmod.replay(self, os.path.join(path, "wal.log"))
            self.wal = walmod.WriteAheadLog(os.path.join(path, "wal.log"))
            self.catalog.attach_wal(self.wal)

    def _read_current(self) -> Optional[str]:
        cur = os.path.join(self.path, "CURRENT")
        if not os.path.exists(cur):
            return None
        with open(cur) as f:
            name = f.read().strip()
        return name or None

    def connect(self) -> "Connection":
        from adacom_tpu_torch.main.connection import Connection

        return Connection(self)

    def cursor(self) -> "Connection":
        return self.connect()

    def checkpoint(self) -> None:
        """Write a full checkpoint, publish it atomically, truncate the WAL
        (reference SingleFileStorageManager::CreateCheckpoint,
        storage_manager.cpp:208). In-memory databases have none."""
        if self.path is None:
            return
        from adacom_tpu_torch.storage.checkpoint import write_checkpoint

        old = self._read_current()
        self._ckpt_seq += 1
        name = f"ckpt-{self._ckpt_seq}"
        write_checkpoint(self, os.path.join(self.path, name))
        if self.config.checkpoint_abort == "before_header":
            # data written but CURRENT not updated: a reopen must recover
            # from the previous checkpoint + the untouched WAL
            raise CheckpointAbort("injected abort before header update")
        tmp = os.path.join(self.path, "CURRENT.tmp")
        with open(tmp, "w") as f:
            f.write(name)
        os.replace(tmp, os.path.join(self.path, "CURRENT"))
        if self.wal is not None:
            self.wal.truncate()
        if old and old != name:
            shutil.rmtree(os.path.join(self.path, old), ignore_errors=True)

    def maybe_autocheckpoint(self) -> None:
        """Checkpoint when the WAL passes the size threshold (reference
        checkpoint-on-WAL-threshold, storage_manager.cpp)."""
        if self.wal is None or self.config.wal_autocheckpoint is None:
            return
        if self.wal.size() >= self.config.wal_autocheckpoint:
            self.checkpoint()

    def close(self) -> None:
        if self._closed:
            return
        if self.path is not None:
            try:
                self.checkpoint()
            except CheckpointAbort:
                pass
            if self.wal is not None:
                self.wal.close()
        self.catalog.shutdown()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
