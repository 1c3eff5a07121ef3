"""Checkpoint/restore: columnar blocks + manifest.

Port of adacom_tpu/storage/checkpoint.py, in the same format, so a
checkpoint written by either package opens in the other. CHECKPOINT
rewrites every table into one ``<table>.<column>.npz`` per column beside a
``manifest.json``; the column files are compressed on a thread pool. Each segment persists its plain host values (the
storage dtype; dictionary codes for VARCHAR, whose dictionary is stored in
plain form beside them) with its state, codec, zonemap and read count.
Packed words are not stored: on load, each stored segment becomes one
segment again, and those whose state was ``packed`` are compacted again
with their codec. A reopened segment starts paged out,
so compaction only flips its state and the first query that reads it
uploads and encodes it on the database's device.

A checkpoint is a consistent cut: `Database.checkpoint` writes one only
while no write transaction is open (the reference's
TransactionManager::CanCheckpoint), and holds, from the first read until
CURRENT is published and the WAL truncated, these locks, taken in this
order:

1. the database's checkpoint lock (one checkpoint at a time; `_ckpt_seq`);
2. the catalog's lock (no table is created or dropped, no transaction
   registers its first write);
3. every table's append lock, in name order (no row, delete or record
   reaches a table or the WAL).

Every other path takes a subset in the same order: the catalog's lock
before a table's (CREATE TABLE AS fills its new table, a transaction's
first write of a table registers), and the WAL's lock last, inside a
table's or the catalog's. No path takes the catalog's lock while it holds a
table's. `write_checkpoint` runs inside all of them, so it flushes with
`Table.flush_locked`."""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def _write_column(path: str, tname: str, col) -> None:
    """One column's npz: every segment's values and validity, and the
    dictionary in plain form."""
    arrays = {}
    for si, seg in enumerate(col.segments):
        sid = f"{tname}.{col.name}.{si}"
        arrays[f"{sid}.values"] = seg._host_values
        if seg._validity_np is not None:
            arrays[f"{sid}.validity"] = seg._validity_np
    if col.dictionary is not None:
        # strings_array() restores the plain form of an FSST dictionary:
        # the format stays codec-independent
        arrays[f"{tname}.{col.name}.dict"] = col.dictionary.strings_array()
    np.savez_compressed(os.path.join(path, f"{tname}.{col.name}.npz"),
                        **arrays)


def write_checkpoint(db, path: str) -> None:
    """Every table, view and index into `path`; the caller holds the locks
    of the module docstring."""
    os.makedirs(path, exist_ok=True)
    manifest: dict = {"version": 1, "tables": {}}
    columns = []
    for tname, table in db.catalog.tables.items():
        table.flush_locked()
        tinfo = {"columns": []}
        for cname in table.column_order:
            col = table.columns[cname]
            t = col.ltype
            tinfo["columns"].append({
                "name": cname,
                "type": t.name,
                "precision": t.precision,
                "scale": t.scale,
                "segments": [{"count": seg.count, "state": seg.state,
                              "codec": seg.codec, "vmin": seg.vmin,
                              "vmax": seg.vmax, "reads": seg.num_reads}
                             for seg in col.segments],
            })
            columns.append((tname, col))
        # deleted-row *indices* (mark_deleted takes indices on restore)
        tinfo["deletes"] = {str(k): np.flatnonzero(v).tolist()
                            for k, v in table._deletes.items()}
        manifest["tables"][tname] = tinfo
    # zlib releases the GIL: the column files compress in parallel
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        for fut in [pool.submit(_write_column, path, tname, col)
                    for tname, col in columns]:
            fut.result()
    manifest["views"] = dict(db.catalog.views)
    manifest["indexes"] = [idx.to_def() for idx in db.catalog.indexes.values()]
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def try_load_database(db, path: str) -> bool:
    mpath = os.path.join(path, "manifest.json")
    if not os.path.exists(mpath):
        return False
    from adacom_tpu_torch import types as tt

    with open(mpath) as f:
        manifest = json.load(f)
    for tname, tinfo in manifest["tables"].items():
        cols = []
        for cinfo in tinfo["columns"]:
            if cinfo["type"] == "DECIMAL":
                ty = tt.DECIMAL(cinfo["precision"], cinfo["scale"])
            else:
                ty = tt.type_from_name(cinfo["type"])
            cols.append((cinfo["name"], ty))
        table = db.catalog.create_table(tname, cols)
        for cinfo in tinfo["columns"]:
            cname = cinfo["name"]
            col = table.columns[cname]
            # the dictionary is an object array, which np.savez pickles
            with np.load(os.path.join(path, f"{tname}.{cname}.npz"),
                         allow_pickle=True) as data:
                if f"{tname}.{cname}.dict" in data:
                    for s in data[f"{tname}.{cname}.dict"]:
                        col.dictionary.encode_one(str(s))
                # one segment per stored segment: the deletes and states
                # below are keyed by segment index, and a table written
                # inside a transaction has short segments mid-table that
                # staging would merge (the JAX package restages, so there
                # its deletes land on other rows or raise)
                for si in range(len(cinfo["segments"])):
                    sid = f"{tname}.{cname}.{si}"
                    validity = (data[f"{sid}.validity"]
                                if f"{sid}.validity" in data else None)
                    col._seal_array(
                        np.ascontiguousarray(data[f"{sid}.values"]), validity)
            # restore compaction states
            for seg, sinfo in zip(col.segments, cinfo["segments"]):
                if sinfo["state"] == "packed":
                    seg.compact(sinfo.get("codec"))
                seg.num_reads = sinfo.get("reads", 0)
        for k, rows in tinfo.get("deletes", {}).items():
            if rows:
                table.mark_deleted(int(k), np.asarray(rows, dtype=np.int64))
    for vname, vsql in manifest.get("views", {}).items():
        db.catalog.views[vname] = vsql
    for idef in manifest.get("indexes", ()):
        db.catalog.create_index(idef["name"], idef["table"], idef["column"],
                                idef["unique"], if_not_exists=True)
    return True
