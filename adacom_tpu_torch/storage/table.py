"""Columns and tables: segment trees, staging ingest, string dictionaries.

Parity targets:
- ColumnData / segment tree (reference src/storage/table/column_data.cpp):
  a column is an ordered list of sealed ColumnSegments plus a host-side
  staging buffer for appends; appending into a sealed partial segment
  un-seals it first (the reference Uncompact()s compacted segments before
  Append, column_segment.cpp:253-259).
- DataTable / RowGroupCollection (src/storage/data_table.cpp,
  row_group_collection.cpp): aligned per-column segments, shared row count,
  append lock, delete bitmaps.
- Dictionary compression for VARCHAR (src/storage/compression/
  dictionary_compression.cpp) is made the *primary* string representation:
  device arrays hold uint32 dict codes; the dictionary lives host-side.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from adacom_tpu_torch import types as tt
from adacom_tpu_torch.storage.segment import ColumnSegment


class StringDictionary:
    """Append-only string dictionary: str <-> uint32 code.

    Cold dictionaries can compact their string storage with the native
    FSST-class codec (reference fsst.cpp + third_party/fsst): the plain
    list swaps for (symbol table, encoded blob, per-string offsets), and
    single entries decode independently (random access preserved). Any
    append / lookup path restores the plain form first — the same
    Uncompact-then-Append discipline segments use."""

    def __init__(self):
        self._codes: Optional[Dict[str, int]] = {}
        self._strings: Optional[List[str]] = []
        self._fsst = None  # (symtab, symlens, n_sym, blob, offs)
        self._count = 0
        self._plain_nbytes: Optional[int] = None

    def __len__(self):
        return self._count if self._strings is None else len(self._strings)

    # ---------------- FSST compaction ----------------
    def compress_fsst(self) -> bool:
        """Swap plain strings for the FSST-encoded form; returns True when
        adopted (native lib present AND the encoding actually shrinks)."""
        if self._fsst is not None or not self._strings:
            return False
        from adacom_tpu_torch import native

        enc = [s.encode("utf-8", "surrogatepass") for s in self._strings]
        corpus = b"".join(enc)
        if len(corpus) < 4096:
            return False
        offs = np.zeros(len(enc) + 1, dtype=np.int64)
        np.cumsum([len(e) for e in enc], out=offs[1:])
        arr = np.frombuffer(corpus, dtype=np.uint8)
        trained = native.fsst_train(arr)
        if trained is None:
            return False
        symtab, symlens, n_sym = trained
        encoded = native.fsst_encode(symtab, symlens, n_sym, arr, offs)
        if encoded is None:
            return False
        blob, eoffs = encoded
        packed = len(blob) + eoffs.nbytes + symtab.nbytes + symlens.nbytes
        if packed >= len(corpus) + offs.nbytes:
            return False  # incompressible (random/binary-ish): keep plain
        self._plain_nbytes = len(corpus) + offs.nbytes
        self._count = len(self._strings)
        self._fsst = (symtab, symlens, n_sym, blob, eoffs)
        self._strings = None
        self._codes = None
        return True

    def _ensure_plain(self) -> None:
        if self._strings is not None:
            return
        from adacom_tpu_torch import native

        symtab, symlens, n_sym, blob, eoffs = self._fsst
        strs = [
            native.fsst_decode(symtab, symlens, n_sym,
                               blob[eoffs[i]:eoffs[i + 1]])
            .decode("utf-8", "surrogatepass")
            for i in range(self._count)
        ]
        self._strings = strs
        self._codes = {s: i for i, s in enumerate(strs)}
        self._fsst = None

    def footprint_bytes(self) -> int:
        """Logical bytes of string storage (GetDataSize-style accounting):
        encoded blob + offsets + symbol table when compressed, utf-8 bytes
        + offsets when plain."""
        if self._fsst is not None:
            symtab, symlens, _, blob, eoffs = self._fsst
            return len(blob) + eoffs.nbytes + symtab.nbytes + symlens.nbytes
        if self._plain_nbytes is None:
            self._plain_nbytes = (
                sum(len(s.encode("utf-8", "surrogatepass"))
                    for s in self._strings)
                + 8 * (len(self._strings) + 1))
        return self._plain_nbytes

    def is_compressed(self) -> bool:
        return self._fsst is not None

    # ---------------- plain interface ----------------
    def encode_one(self, s: str) -> int:
        self._ensure_plain()
        code = self._codes.get(s)
        if code is None:
            code = len(self._strings)
            self._codes[s] = code
            self._strings.append(s)
            self._plain_nbytes = None
        return code

    def encode(self, values: Sequence) -> np.ndarray:
        self._ensure_plain()
        out = np.empty(len(values), dtype=np.uint32)
        enc = self.encode_one
        for i, v in enumerate(values):
            out[i] = enc(v if isinstance(v, str) else ("" if v is None else str(v)))
        return out

    def lookup(self, s: str) -> Optional[int]:
        self._ensure_plain()
        return self._codes.get(s)

    def decode(self, codes: np.ndarray) -> List[str]:
        if self._fsst is not None:
            # random access into the compressed form: decode only the
            # requested codes, memoized (point lookups stay cheap)
            from adacom_tpu_torch import native

            symtab, symlens, n_sym, blob, eoffs = self._fsst
            memo: Dict[int, str] = {}
            out = []
            for c in codes:
                c = int(c)
                got = memo.get(c)
                if got is None:
                    got = native.fsst_decode(
                        symtab, symlens, n_sym, blob[eoffs[c]:eoffs[c + 1]]
                    ).decode("utf-8", "surrogatepass")
                    memo[c] = got
                out.append(got)
            return out
        strs = self._strings
        return [strs[c] for c in codes]

    def strings_array(self) -> np.ndarray:
        self._ensure_plain()
        return np.asarray(self._strings, dtype=object)

    def rank_array(self) -> np.ndarray:
        """rank[code] = position of the string in sorted order (for ORDER BY
        / range comparisons on dictionary codes)."""
        self._ensure_plain()
        order = np.argsort(np.asarray(self._strings, dtype=object), kind="stable")
        rank = np.empty(len(self._strings), dtype=np.uint32)
        rank[order] = np.arange(len(self._strings), dtype=np.uint32)
        return rank


class TransactionConflict(Exception):
    """Write-write conflict (reference TransactionException on conflict)."""


class TableSnapshot:
    """Consistent read view of a table: per-column segment tuples + a
    pinned delete-mask dict, captured atomically under the append lock.

    Fixes the reference's scan-vs-compaction races (SURVEY §2.1 known
    defects; the fork mutates segment state under concurrent scans with
    only ``bit_compression_lock``) AND this engine's own round-4 race: a
    candidate list from zonemap probing outlived a concurrent
    ``unseal_last_partial`` segment-list pop, so ``columns[c].segments[i]``
    threw IndexError mid-scan. Readers now resolve every segment through
    the snapshot; writers never mutate a snapshotted tuple. Delete masks
    are copy-on-write (``Table.mark_deleted``), so a pinned dict is a
    stable version — the reader-side analogue of the reference's
    per-vector version arrays (src/storage/table/chunk_info.cpp)."""

    __slots__ = ("column_order", "seglists", "deletes")

    def __init__(self, column_order, seglists, deletes):
        self.column_order = column_order
        self.seglists: Dict[str, tuple] = seglists
        self.deletes: Dict[int, np.ndarray] = deletes

    def segment(self, col: str, i: int) -> ColumnSegment:
        return self.seglists[col][i]

    def segments(self, col: str) -> tuple:
        return self.seglists[col]

    def segment_count(self) -> int:
        if not self.column_order:
            return 0
        return len(self.seglists[self.column_order[0]])

    def segment_rows(self, i: int) -> int:
        return self.seglists[self.column_order[0]][i].count

    def delete_mask(self, i: int) -> Optional[np.ndarray]:
        return self.deletes.get(i)


class Column:
    def __init__(self, name: str, ltype: tt.LogicalType, config, bm, seg_catalog):
        self.name = name
        self.ltype = ltype
        self.config = config
        self.bm = bm
        self.seg_catalog = seg_catalog
        self.segments: List[ColumnSegment] = []
        self.dictionary: Optional[StringDictionary] = (
            StringDictionary() if ltype.is_string else None
        )
        if self.dictionary is not None and seg_catalog is not None:
            seg_catalog.add_dictionary_column(self)
        # staging: list of (values, validity|None) numpy chunks not yet sealed
        self._staging: List[tuple] = []
        self._staged_rows = 0

    # ---------------- ingest ----------------
    def stage(self, values: np.ndarray, validity: Optional[np.ndarray] = None):
        values = np.ascontiguousarray(values)
        self._staging.append((values, validity))
        self._staged_rows += len(values)
        seg_rows = self.config.segment_rows
        if self._staged_rows < seg_rows:
            return
        # concatenate once, seal every full segment as a zero-copy slice,
        # keep only the tail staged
        vals, mask = self._concat_staging()
        n_full = len(vals) // seg_rows
        for k in range(n_full):
            sl = slice(k * seg_rows, (k + 1) * seg_rows)
            self._seal_array(vals[sl], mask[sl] if mask is not None else None)
        rest_v = vals[n_full * seg_rows :]
        rest_m = mask[n_full * seg_rows :] if mask is not None else None
        self._staging = [(rest_v, rest_m)] if len(rest_v) else []
        self._staged_rows = len(rest_v)

    def _concat_staging(self):
        vals = np.concatenate([v for v, _ in self._staging]) if len(self._staging) > 1 else self._staging[0][0]
        if any(m is not None for _, m in self._staging):
            masks = [
                (m if m is not None else np.ones(len(v), dtype=np.bool_))
                for v, m in self._staging
            ]
            mask = np.concatenate(masks) if len(masks) > 1 else masks[0]
        else:
            mask = None
        return vals, mask

    def _seal_array(self, vals: np.ndarray, mask: Optional[np.ndarray]):
        start_row = sum(s.count for s in self.segments)
        seg = ColumnSegment(
            self.ltype, vals, self.config, self.bm,
            validity=mask, start_row=start_row,
        )
        self.segments.append(seg)
        self.bm.add_to_data_size(seg.footprint_bytes())
        if self.seg_catalog is not None:
            self.seg_catalog.add_column_segment(seg)

    def flush(self):
        """Seal any partial staging into a (short) final segment."""
        if self._staged_rows:
            vals, mask = self._concat_staging()
            self._seal_array(vals, mask)
            self._staging = []
            self._staged_rows = 0

    def unseal_last_partial(self):
        """Pull a trailing partial segment back into staging so appends can
        continue filling it (reference: Uncompact-then-Append)."""
        if self._staged_rows or not self.segments:
            return
        last = self.segments[-1]
        if last.count >= self.config.segment_rows:
            return
        self.segments.pop()
        if self.seg_catalog is not None:
            self.seg_catalog.remove_column_segment(last)
        self.bm.add_to_data_size(-last.footprint_bytes())
        last.page_out()
        vals = last._host_values
        mask = last._validity_np
        self._staging = [(vals, mask)]
        self._staged_rows = len(vals)

    # ---------------- info ----------------
    def row_count(self) -> int:
        return sum(s.count for s in self.segments) + self._staged_rows

    def footprint_bytes(self) -> int:
        n = sum(s.footprint_bytes() for s in self.segments)
        n += self._staged_rows * self.ltype.np_dtype.itemsize
        return n

    def compact_all(self):
        self.flush()
        for s in self.segments:
            s.compact()
        if self.dictionary is not None and \
                getattr(self.config, "fsst_dictionary_enabled", True):
            self.dictionary.compress_fsst()

    def uncompact_all(self):
        for s in self.segments:
            s.uncompact()
        if self.dictionary is not None:
            self.dictionary._ensure_plain()


class Table:
    def __init__(self, name: str, columns: List[tuple], config, bm, seg_catalog):
        """columns: list of (name, LogicalType)."""
        self.name = name
        self.config = config
        self.bm = bm
        self.column_order = [c for c, _ in columns]
        self.columns: Dict[str, Column] = {
            c: Column(c, t, config, bm, seg_catalog) for c, t in columns
        }
        self._append_lock = threading.Lock()
        # deleted-row bitmaps, one bool array per sealed segment index
        self._deletes: Dict[int, np.ndarray] = {}
        self._has_deletes = False
        # write-ahead log (attached by Catalog when the db is durable)
        self.wal = None
        # MVCC visibility (reference chunk_info.cpp version arrays +
        # transaction-local storage, adapted to append-only segments):
        # while a transaction WRITES this table, other connections clamp
        # scans to the committed watermark and read the committed delete
        # masks; the writer reads its own rows live. Commit publishes,
        # rollback truncates back. One write transaction per table at a
        # time (a second writer gets a TransactionConflict, the
        # reference's optimistic-conflict abort).
        self.write_txn: Optional[int] = None  # owning connection token
        self.committed_rows: Optional[int] = None
        self.committed_deletes: Optional[Dict[int, np.ndarray]] = None
        self.no_unseal = False  # fresh segments only while a txn writes
        # secondary indexes (storage/index.py; reference ART per-table list)
        self.indexes: list = []

    @property
    def column_types(self) -> List[tt.LogicalType]:
        return [self.columns[c].ltype for c in self.column_order]

    def row_count(self) -> int:
        if not self.column_order:
            return 0
        return self.columns[self.column_order[0]].row_count()

    # ---------------- ingest ----------------
    def append_batch(self, data: Dict[str, np.ndarray], validity: Optional[Dict[str, np.ndarray]] = None):
        """Append aligned column arrays (one batch of rows)."""
        with self._append_lock:
            n = None
            for c in self.column_order:
                if c not in data:
                    raise KeyError(f"missing column {c} in append")
                if n is None:
                    n = len(data[c])
                elif len(data[c]) != n:
                    raise ValueError("ragged append batch")
            normalized: Dict[str, np.ndarray] = {}
            for c in self.column_order:
                col = self.columns[c]
                vals = data[c]
                if col.dictionary is not None and (
                    not isinstance(vals, np.ndarray) or vals.dtype.kind in "OUS"
                ):
                    vals = col.dictionary.encode(list(vals))
                else:
                    vals = np.asarray(vals)
                    if vals.dtype != col.ltype.np_dtype:
                        vals = vals.astype(col.ltype.np_dtype)
                normalized[c] = vals
            for idx in self.indexes:
                if idx.unique:
                    # seal staging first so the index sees all prior rows
                    for cn in self.column_order:
                        self.columns[cn].flush()
                    idx.check_batch_unique(normalized[idx.column])
            if self.wal is not None:
                # WAL stores logical content: dictionary columns as strings
                # (the dictionary is rebuilt on replay, codes are not stable)
                wal_data = {}
                for c in self.column_order:
                    col = self.columns[c]
                    if col.dictionary is not None:
                        wal_data[c] = np.asarray(
                            col.dictionary.decode(normalized[c].astype(np.int64)),
                            dtype=object)
                    else:
                        wal_data[c] = normalized[c]
                self.wal.log_insert(self.name, wal_data, validity)
            for c in self.column_order:
                col = self.columns[c]
                if not self.no_unseal:
                    # in-flight txn: rewriting the tail segment would mix
                    # committed and uncommitted rows across the watermark
                    col.unseal_last_partial()
                col.stage(normalized[c], validity.get(c) if validity else None)

    def flush(self):
        with self._append_lock:
            for c in self.column_order:
                self.columns[c].flush()

    # ---------------- scan support ----------------
    def segment_count(self) -> int:
        self.flush()
        if not self.column_order:
            return 0
        return len(self.columns[self.column_order[0]].segments)

    def segment(self, col: str, i: int) -> ColumnSegment:
        return self.columns[col].segments[i]

    def segment_rows(self, i: int) -> int:
        return self.columns[self.column_order[0]].segments[i].count

    def delete_mask(self, i: int) -> Optional[np.ndarray]:
        return self._deletes.get(i)

    def read_snapshot(self, token: Optional[int] = None) -> TableSnapshot:
        """Pin a consistent scan view (see TableSnapshot). ``token`` is the
        reader's connection token for MVCC: while another connection's
        write transaction is in flight, the snapshot is clamped to the
        committed watermark and carries the committed delete masks."""
        with self._append_lock:
            self.flush_locked()
            if self.write_txn is not None and self.write_txn != token:
                limit = self.committed_rows
                dels = dict(self.committed_deletes)
            else:
                limit = None
                dels = dict(self._deletes)
            seglists = {
                c: tuple(self.columns[c].segments) for c in self.column_order
            }
            if limit is not None and self.column_order:
                col0 = seglists[self.column_order[0]]
                total = vis = 0
                for seg in col0:
                    if total + seg.count > limit:
                        break
                    total += seg.count
                    vis += 1
                if vis < len(col0):
                    seglists = {c: s[:vis] for c, s in seglists.items()}
            return TableSnapshot(self.column_order, seglists, dels)

    def truncate(self) -> None:
        """DELETE without WHERE: drop all rows IN PLACE, preserving the
        table object, its indexes, and dependent views (DuckDB delete-all
        semantics via src/storage/data_table.cpp — the round-4 drop-and-
        recreate path silently lost indexes, so UNIQUE stopped being
        enforced)."""
        with self._append_lock:
            if self.wal is not None:
                self.wal.log_truncate(self.name)
            for c in self.column_order:
                col = self.columns[c]
                for s in col.segments:
                    self.bm.add_to_data_size(-s.footprint_bytes())
                    if col.seg_catalog is not None:
                        col.seg_catalog.remove_column_segment(s)
                    s.page_out()
                col.segments = []
                col._staging = []
                col._staged_rows = 0
            self._deletes = {}
            self._has_deletes = False
            for idx in self.indexes:
                idx.invalidate()

    # ---------------- MVCC write ownership ----------------
    def begin_write_txn(self, token: int) -> None:
        """First write by a transaction: pin the committed watermark and
        snapshot the delete masks (copy-on-write for readers)."""
        with self._append_lock:
            if self.write_txn is not None and self.write_txn != token:
                raise TransactionConflict(
                    f"table {self.name!r} is being written by another "
                    "transaction")
            if self.write_txn == token:
                return
            self.flush_locked()
            self.write_txn = token
            self.committed_rows = self.row_count()
            self.committed_deletes = {
                i: m.copy() for i, m in self._deletes.items()}
            self.no_unseal = True

    def end_write_txn(self, token: int) -> None:
        with self._append_lock:
            if self.write_txn != token:
                return
            self.write_txn = None
            self.committed_rows = None
            self.committed_deletes = None
            self.no_unseal = False

    def snapshot_for(self, token: Optional[int]):
        """(visible_row_limit, delete_masks) for a reader: live state for
        the owning writer / idle tables; the committed snapshot for
        everyone else while a write txn is in flight."""
        if self.write_txn is None or self.write_txn == token:
            return None, None
        return self.committed_rows, self.committed_deletes

    def flush_locked(self):
        for c in self.column_order:
            self.columns[c].flush()

    def mark_deleted(self, seg_idx: int, rows: np.ndarray, _log=True):
        self.mark_deleted_many([(seg_idx, rows)], _log=_log)

    def mark_deleted_many(self, updates, _log=True):
        """Apply a DELETE statement's per-segment row sets ATOMICALLY:
        one lock acquisition publishes every affected segment's new mask,
        so a reader snapshot sees all of the statement or none of it.

        Masks are copy-on-write: each update builds a NEW array and swaps
        the dict entry, never mutating a published one — readers holding a
        TableSnapshot keep a stable pinned version (the reference's
        chunk_info version-array discipline, reduced to delete masks)."""
        with self._append_lock:
            self.flush_locked()
            col0 = self.columns[self.column_order[0]]
            for seg_idx, rows in updates:
                if self.wal is not None and _log:
                    self.wal.log_delete(self.name, seg_idx, rows,
                                        col0.segments[seg_idx].start_row)
                seg_rows = col0.segments[seg_idx].count
                m = self._deletes.get(seg_idx)
                if m is None:
                    m2 = np.zeros(seg_rows, dtype=np.bool_)
                elif len(m) < seg_rows:
                    # the tail segment was unsealed and re-sealed LARGER
                    # after these rows were deleted (append into a partial
                    # segment); the old prefix rows keep their positions —
                    # grow the mask
                    m2 = np.concatenate(
                        [m, np.zeros(seg_rows - len(m), dtype=np.bool_)])
                else:
                    m2 = m.copy()
                m2[rows] = True
                self._deletes[seg_idx] = m2
            self._has_deletes = True

    def index_on(self, col: str):
        """First single-column index over `col`, or None (optimizer
        index-scan rewrite probe, reference table_scan.cpp:388)."""
        cl = col.lower()
        for idx in self.indexes:
            if idx.column == cl:
                return idx
        return None

    def index_on_columns(self, cols) -> object:
        """Index whose key columns are exactly `cols` (any order), or
        None — serves composite equality probes and index joins."""
        want = frozenset(c.lower() for c in cols)
        for idx in self.indexes:
            if frozenset(idx.columns) == want:
                return idx
        return None

    def compact_all(self):
        for c in self.column_order:
            self.columns[c].compact_all()

    def uncompact_all(self):
        for c in self.column_order:
            self.columns[c].uncompact_all()

    def footprint_bytes(self) -> int:
        return sum(self.columns[c].footprint_bytes() for c in self.column_order)
