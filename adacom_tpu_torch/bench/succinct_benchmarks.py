"""The [succinct] benchmark group.

One class per reference benchmark (benchmark/micro/succinct/*.cpp), same
names, workloads, and measured phases; `scale` scales the reference row
counts (scale=1.0 reproduces them exactly).

Reference parameters:
- ZipfDistribution:      100M u32 sequential inserts, 10k Zipf(k=1) point
  lookups (zipf_distribution.cpp:14-16)
- NormalDistribution:    sequential inserts, 10k N(n/2, n/4) lookups
  (normal_distribution.cpp:11-31)
- SequentialInsert:      timed 100M-row sequential insert (sequential.cpp)
- Random:                random u32 inserts + lookups (random.cpp)
- ScanOOM / ZipfScanOOM: 150M rows under PRAGMA memory_limit='1GB'; 100
  full scans / 10k Zipf(k=2) lookups (out_of_memory.cpp:12-15)
- ZipfOverTime:          lookups under background adaptive compaction with
  per-interval QPS + memory reporting (zipf_over_time.cpp:69-75)
- DiffSkews:             Zipf skew sweep k=0..2 (zipf_distribution_diff_skews.cpp)
- DistributionChanging:  the Zipf hot-spot jumps mid-run
  (distribution_changing.cpp, zipf_distribution_changing.cpp)
- FBWorkload:            synthetic stand-in for the missing
  data/fb_workloads binary u64 trace (fb_binary_data_loader.cpp:8-44)

Port of adacom_tpu/bench/succinct_benchmarks.py: the same 20 classes,
parameters and seeds. Every database is built on the benchmark's
platform (`Benchmark.platform`, "cuda" unless the caller asks for "cpu").
FBWorkload's UBIGINT column keeps every plan on the host tier
(exec/device_scan.declines), as designed.
"""

from __future__ import annotations

import time

import numpy as np

from adacom_tpu_torch.bench.runner import Benchmark, register
from adacom_tpu_torch.bench.zipf import ZipfSampler


def _mk_db(platform, succinct=True, adaptive=False, padded=False,
          memory_limit=None):
    import adacom_tpu_torch as at

    cfg = at.DBConfig()
    cfg.succinct_enabled = succinct
    cfg.adaptive_succinct_compression_enabled = adaptive
    cfg.succinct_padded_to_next_byte_enabled = padded
    if memory_limit is not None:
        cfg.memory_limit = memory_limit
    db = at.Database(config=cfg, platform=platform)
    return db, db.connect()


def _ingest_sequential(con, n, dtype=np.uint32):
    app = con.appender("t1")
    chunk = 8 << 20
    for start in range(0, n, chunk):
        app.append_column("i", np.arange(start, min(start + chunk, n), dtype=dtype))
    app.close()


class _LookupBenchmark(Benchmark):
    """Common shape: sequential ingest + point-lookup run phase."""

    succinct = True
    padded = False
    base_rows = 100_000_000
    n_lookups = 10_000

    def _lookups(self, state, n):
        raise NotImplementedError

    def load(self, state):
        n = max(1024, int(self.base_rows * self.scale))
        db, con = _mk_db(self.platform, succinct=self.succinct, padded=self.padded)
        con.query("CREATE TABLE t1(i UINTEGER)")
        _ingest_sequential(con, n)
        state.update(db=db, con=con, n=n, data=self._lookups(state, n))
        if self.succinct:
            # reference: CompactAllSegments after load (zipf_distribution.cpp:37)
            db.catalog.get_column_segment_catalog().compact_all_segments()

    def run(self, state):
        con = state["con"]
        con.query("BEGIN TRANSACTION")
        for v in state["data"]:
            state["result"] = con.query(f"SELECT i FROM t1 WHERE i == {v}")
        con.query("COMMIT")

    def verify(self, state):
        v = int(state["data"][-1])
        res = state["result"]
        if v < state["n"]:
            if res.row_count != 1 or int(res.column(0)[0]) != v:
                return f"lookup {v} returned {res.fetchall()[:3]}"
        return None


@register
class SuccinctZipfDistribution(_LookupBenchmark):
    name = "SuccinctZipfDistribution"

    def _lookups(self, state, n):
        return ZipfSampler(n, 1.0, seed=7).sample(self.n_lookups)


@register
class SuccinctPaddedZipfDistribution(SuccinctZipfDistribution):
    name = "SuccinctPaddedZipfDistribution"
    padded = True


@register
class NonSuccinctZipfDistribution(SuccinctZipfDistribution):
    name = "NonSuccinctZipfDistribution"
    succinct = False


@register
class SuccinctNormalDistribution(_LookupBenchmark):
    name = "SuccinctNormalDistribution"

    def _lookups(self, state, n):
        rng = np.random.default_rng(11)
        vals = rng.normal(n / 2, n / 4, size=self.n_lookups)
        return np.clip(np.round(vals), 0, n - 1).astype(np.int64)


@register
class NonSuccinctNormalDistribution(SuccinctNormalDistribution):
    name = "NonSuccinctNormalDistribution"
    succinct = False


@register
class SuccinctRandomDistribution(_LookupBenchmark):
    name = "SuccinctRandomDistribution"

    def _lookups(self, state, n):
        return np.random.default_rng(13).integers(0, n, self.n_lookups)


@register
class NonSuccinctRandomDistribution(SuccinctRandomDistribution):
    name = "NonSuccinctRandomDistribution"
    succinct = False


# ---------------- timed inserts (sequential.cpp) ----------------


class _InsertBenchmark(Benchmark):
    succinct = True
    padded = False
    base_rows = 100_000_000

    def load(self, state):
        db, con = _mk_db(self.platform, succinct=self.succinct, padded=self.padded)
        state.update(db=db, con=con, n=max(1024, int(self.base_rows * self.scale)), it=0)

    def run(self, state):
        con = state["con"]
        it = state["it"]
        state["it"] += 1
        con.query(f"CREATE TABLE t_ins_{it}(i UINTEGER)")
        app = con.appender(f"t_ins_{it}")
        n = state["n"]
        chunk = 8 << 20
        for start in range(0, n, chunk):
            app.append_column("i", np.arange(start, min(start + chunk, n), dtype=np.uint32))
        app.close()
        if self.succinct:
            state["db"].catalog.get_column_segment_catalog().compact_all_segments()
        # keep memory bounded between runs: drop previous table
        if it > 0:
            con.query(f"DROP TABLE t_ins_{it - 1}")

    def verify(self, state):
        it = state["it"] - 1
        cnt = state["con"].query(f"SELECT count(*) FROM t_ins_{it}").scalar()
        return None if int(cnt) == state["n"] else f"count {cnt} != {state['n']}"


@register
class SuccinctSequentialInsert(_InsertBenchmark):
    name = "SuccinctSequentialInsert"


@register
class SuccinctPaddedSequentialInsert(_InsertBenchmark):
    name = "SuccinctPaddedSequentialInsert"
    padded = True


@register
class NonSuccinctSequentialInsert(_InsertBenchmark):
    name = "NonSuccinctSequentialInsert"
    succinct = False


# ---------------- OOM scans (out_of_memory.cpp) ----------------


class _ScanOOM(Benchmark):
    succinct = True
    base_rows = 150_000_000
    n_scans = 100

    def load(self, state):
        n = max(1024, int(self.base_rows * self.scale))
        limit = max(1 << 20, int(1_000_000_000 * self.scale))
        db, con = _mk_db(self.platform, succinct=self.succinct,
                         memory_limit=limit)
        con.query("CREATE TABLE t1(i INTEGER)")
        _ingest_sequential(con, n, dtype=np.int32)
        if self.succinct:
            db.catalog.get_column_segment_catalog().compact_all_segments()
        state.update(db=db, con=con, n=n)

    def run(self, state):
        con = state["con"]
        for _ in range(self.n_scans):
            state["result"] = con.query("SELECT count(*), sum(i) FROM t1")

    def verify(self, state):
        n = state["n"]
        cnt, s = state["result"].fetchone()
        if int(cnt) != n or int(s) != n * (n - 1) // 2:
            return f"scan got ({cnt},{s})"
        return None


@register
class SuccinctScanOOM(_ScanOOM):
    name = "SuccinctScanOOM"


@register
class NonSuccinctScanOOM(_ScanOOM):
    name = "NonSuccinctScanOOM"
    succinct = False


class _ZipfScanOOM(_LookupBenchmark):
    base_rows = 150_000_000
    succinct = True

    def load(self, state):
        n = max(1024, int(self.base_rows * self.scale))
        limit = max(1 << 20, int(1_000_000_000 * self.scale))
        db, con = _mk_db(self.platform, succinct=self.succinct,
                         memory_limit=limit)
        con.query("CREATE TABLE t1(i INTEGER)")
        _ingest_sequential(con, n, dtype=np.int32)
        if self.succinct:
            db.catalog.get_column_segment_catalog().compact_all_segments()
        state.update(db=db, con=con, n=n,
                     data=ZipfSampler(n, 2.0, seed=23).sample(10_000))


@register
class SuccinctZipfScanOOM(_ZipfScanOOM):
    name = "SuccinctZipfScanOOM"


@register
class NonSuccinctZipfScanOOM(_ZipfScanOOM):
    name = "NonSuccinctZipfScanOOM"
    succinct = False


# ---------------- adaptive over-time benchmarks ----------------


@register
class ZipfOverTime(Benchmark):
    """Adaptive compaction under a Zipf workload; logs per-interval QPS and
    memory (reference zipf_over_time.cpp:69-75). The timed run executes a
    fixed number of lookups while the background policy recompresses."""

    name = "ZipfOverTime"
    base_rows = 100_000_000
    n_lookups = 20_000
    nruns = 3

    def load(self, state):
        import adacom_tpu_torch as at

        n = max(1024, int(self.base_rows * self.scale))
        cfg = at.DBConfig()
        cfg.adaptive_succinct_compression_enabled = True
        cfg.compaction_period_s = 1.0
        db = at.Database(config=cfg, platform=self.platform)
        con = db.connect()
        con.query("CREATE TABLE t1(i UINTEGER)")
        _ingest_sequential(con, n)
        db.catalog.get_column_segment_catalog().compact_all_segments()
        state.update(db=db, con=con, n=n,
                     data=ZipfSampler(n, 1.0, seed=31).sample(self.n_lookups))

    def run(self, state):
        con = state["con"]
        cat = state["db"].catalog.get_column_segment_catalog()
        t_int = time.perf_counter()
        done = 0
        for k, v in enumerate(state["data"]):
            con.query(f"SELECT i FROM t1 WHERE i == {v}")
            done += 1
            now = time.perf_counter()
            if now - t_int >= 1.0:
                print(f"# qps={done / (now - t_int):.0f} "
                      f"mem={cat.get_total_data_size()}", flush=True)
                t_int = now
                done = 0

    def cleanup(self, state):
        state["db"].catalog.get_column_segment_catalog().disable_background_compaction()
        state["db"].close()


@register
class ZipfDistributionDiffSkews(Benchmark):
    """Zipf skew sweep k=0.0..2.0 (reference zipf_distribution_diff_skews.cpp
    / run_diff_zipfian.sh)."""

    name = "ZipfDistributionDiffSkews"
    base_rows = 100_000_000
    n_lookups = 2_000
    nruns = 1

    def load(self, state):
        db, con = _mk_db(self.platform, succinct=True)
        n = max(1024, int(self.base_rows * self.scale))
        con.query("CREATE TABLE t1(i UINTEGER)")
        _ingest_sequential(con, n)
        db.catalog.get_column_segment_catalog().compact_all_segments()
        state.update(db=db, con=con, n=n)

    def run(self, state):
        con = state["con"]
        n = state["n"]
        for k10 in range(0, 21, 4):  # k = 0.0, 0.4, ..., 2.0
            k = k10 / 10.0
            if k == 0.0:
                vals = np.random.default_rng(41).integers(1, n, self.n_lookups)
            else:
                vals = ZipfSampler(n, k, seed=41).sample(self.n_lookups)
            t0 = time.perf_counter()
            for v in vals:
                con.query(f"SELECT i FROM t1 WHERE i == {v}")
            print(f"# skew k={k:.1f}: {time.perf_counter() - t0:.3f}s "
                  f"for {self.n_lookups} lookups", flush=True)


@register
class DistributionChanging(Benchmark):
    """Zipf hot-spot jumps to a different region mid-run under adaptive
    compaction (reference distribution_changing.cpp)."""

    name = "DistributionChanging"
    base_rows = 100_000_000
    n_lookups = 10_000
    nruns = 2

    def load(self, state):
        import adacom_tpu_torch as at

        cfg = at.DBConfig()
        cfg.adaptive_succinct_compression_enabled = True
        cfg.compaction_period_s = 1.0
        db = at.Database(config=cfg, platform=self.platform)
        con = db.connect()
        n = max(1024, int(self.base_rows * self.scale))
        con.query("CREATE TABLE t1(i UINTEGER)")
        _ingest_sequential(con, n)
        db.catalog.get_column_segment_catalog().compact_all_segments()
        z = ZipfSampler(n, 1.0, seed=51)
        half = self.n_lookups // 2
        a = z.sample(half)
        b_ = (n - 1) - z.sample(self.n_lookups - half)  # hot spot flips ends
        state.update(db=db, con=con, n=n, data=np.concatenate([a, b_]))

    def run(self, state):
        con = state["con"]
        for v in state["data"]:
            con.query(f"SELECT i FROM t1 WHERE i == {v}")

    def cleanup(self, state):
        state["db"].catalog.get_column_segment_catalog().disable_background_compaction()
        state["db"].close()


@register
class FBWorkload(Benchmark):
    """Synthetic stand-in for the reference's Facebook production trace
    (prefix-random u64 keys; the binary files under data/fb_workloads are
    not in the reference repo — fb_binary_data_loader.cpp:8-44)."""

    name = "FBWorkload"
    base_rows = 53_000_000
    n_lookups = 10_000
    nruns = 3

    def load(self, state):
        db, con = _mk_db(self.platform, succinct=True)
        n = max(1024, int(self.base_rows * self.scale))
        rng = np.random.default_rng(61)
        # prefix-random: shared high bits per block, random low bits (u64)
        prefixes = rng.integers(0, 1 << 20, size=(n // 1024 + 1)).astype(np.uint64) << np.uint64(40)
        keys = prefixes[np.arange(n) // 1024] | rng.integers(0, 1 << 24, n).astype(np.uint64)
        con.query("CREATE TABLE t1(i UBIGINT)")
        app = con.appender("t1")
        app.append_column("i", keys)
        app.close()
        db.catalog.get_column_segment_catalog().compact_all_segments()
        lookups = keys[ZipfSampler(n, 1.0, seed=62).sample(self.n_lookups) - 1]
        state.update(db=db, con=con, n=n, data=lookups, keys=keys)

    def run(self, state):
        con = state["con"]
        for v in state["data"]:
            state["result"] = con.query(f"SELECT i FROM t1 WHERE i == {v}")

    def verify(self, state):
        if state["result"].row_count < 1:
            return "lookup missed"
        return None
