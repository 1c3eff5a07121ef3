"""The full ClickBench 43-query suite over a synthetic `hits` table.

The reference carries ClickBench with its 100M-row hits dataset and
answer files (benchmark/clickbench/{queries/q01..q43.sql, answers}); the
dataset itself is not fetchable here, so this module generates a
synthetic hits table covering every column the 43 queries touch, and
registers the queries with their ORIGINAL text (adaptations are limited
to nothing — the engine parses the reference SQL verbatim; sqlite-side
rewrites live in ORACLE_QUERIES). Correctness is established row-for-row
against a sqlite oracle loaded with the same data
(tests/test_clickbench.py) — the benchmark-as-test strategy of SURVEY §4.

Run: python3 -m adacom_tpu_torch.bench.runner ClickBench --scale 0.1
(scale 1.0 = 10M rows; the reference corpus is 100M; add --platform cpu
to run without a card), or tools/clickbench_run.py for the whole suite on
one shared load.

Port of adacom_tpu/bench/clickbench.py: the same 43 query texts, oracle
translations and ClickBench_Q01..Q43 registry, each database on the
benchmark's platform. One divergence in the data: URLHash and RefererHash
are a stable hash of the string (``stable_hash``: blake2b, 8 bytes,
little-endian, top bit cleared) where the JAX package uses Python's
``hash()``, which is salted per process, so a sqlite oracle in another
process loads the same hashes. Every other column draws the same random
stream as the JAX package's ``generate``, and the probe constants are
planted in the same rows."""

from __future__ import annotations

import hashlib

import numpy as np

BASE_ROWS = 10_000_000

# 2013-07-01 .. 2013-07-31 in days-since-epoch (the window q37..q43 probe)
_JUL1, _JUL31 = 15887, 15917

PHRASES = [
    "", "", "", "", "", "",  # most hits carry no search phrase
    "weather today", "cheap flights", "python tutorial", "news",
    "maps", "translate", "pizza near me", "cat videos", "stock prices",
    "email login", "football scores", "how to cook rice",
]
MODELS = ["", "", "", "", "iPhone 5", "Galaxy S4", "Nexus 4", "Lumia 920",
          "Xperia Z", "One X"]
DOMAINS = ["example.com", "shop.example.org", "news.site.net",
           "www.google.com", "maps.google.com", "mail.google.ru",
           "video.host.io", "forum.board.org", "wiki.books.net",
           "m.social.app"]
TITLE_WORDS = ["Breaking", "Google", "Review", "Guide", "Official", "Best",
               "Cheap", "New", "Top", "Daily"]

# the planted probe constants the reference queries look up verbatim
PROBE_USERID = 435090932899640449
PROBE_REFERERHASH = 3594120000172545465
PROBE_URLHASH = 2868770270353813622


def stable_hash(s: str) -> int:
    """A non-negative int64 hash of `s`, the same in every process."""
    digest = hashlib.blake2b(s.encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & 0x7FFF_FFFF_FFFF_FFFF


def _stable_hashes(strings) -> np.ndarray:
    """stable_hash of each string, hashing each distinct string once."""
    table = dict.fromkeys(strings)
    for s in table:
        table[s] = stable_hash(s)
    return np.fromiter((table[s] for s in strings), dtype=np.int64,
                       count=len(strings))


def generate(scale: float = 0.01, seed: int = 20130714) -> dict:
    n = max(2048, int(BASE_ROWS * scale))
    rng = np.random.default_rng(seed)
    event_date = (_JUL1 - 14 + rng.integers(0, 60, n)).astype(np.int32)
    # unique eventtime makes ORDER BY EventTime deterministic (q24/q25/q27)
    event_time = (event_date.astype(np.int64) * 86_400_000_000
                  + rng.integers(0, 86_400, n) * 1_000_000
                  + np.arange(n, dtype=np.int64) % 1_000_000)
    counter = np.where(rng.random(n) < 0.08, 62,
                       rng.integers(1, 1000, n)).astype(np.int32)
    user = (rng.zipf(1.3, n) % max(16, n // 3)).astype(np.int64) + 1
    user[rng.integers(0, n, max(2, n // 5000))] = PROBE_USERID
    dom = np.asarray(DOMAINS, dtype=object)[rng.integers(0, len(DOMAINS), n)]
    pathn = rng.integers(0, max(16, n // 20), n)
    url = np.asarray([f"http://{d}/p/{p}" for d, p in zip(dom, pathn)],
                     dtype=object)
    t1 = np.asarray(TITLE_WORDS, dtype=object)[rng.integers(0, 10, n)]
    t2 = np.asarray(TITLE_WORDS, dtype=object)[rng.integers(0, 10, n)]
    title = np.asarray([f"{a} {b} page" for a, b in zip(t1, t2)],
                       dtype=object)
    rdom = np.asarray(DOMAINS, dtype=object)[rng.integers(0, len(DOMAINS), n)]
    referer = np.asarray(
        [("" if r < 0.4 else f"http://{d}/r/{i % 97}")
         for i, (r, d) in enumerate(zip(rng.random(n), rdom))], dtype=object)
    urlhash = _stable_hashes(url)
    refererhash = _stable_hashes(referer)
    # plant the q41/q42 probe hashes on CounterID=62 rows inside the window
    in_win = (counter == 62) & (event_date >= _JUL1) & (event_date <= _JUL31)
    win_idx = np.nonzero(in_win)[0]
    if len(win_idx) >= 8:
        refererhash[win_idx[::3]] = PROBE_REFERERHASH
        urlhash[win_idx[1::3]] = PROBE_URLHASH
    return {
        "hits": {
            "watchid": ("BIGINT", rng.integers(1, 1 << 60, n)),
            "title": ("VARCHAR", title),
            "eventtime": ("TIMESTAMP", event_time),
            "eventdate": ("DATE", event_date),
            "counterid": ("INTEGER", counter),
            "clientip": ("INTEGER",
                         rng.integers(0, 1 << 31, n).astype(np.int32)),
            "regionid": ("INTEGER", rng.integers(1, 200, n).astype(np.int32)),
            "userid": ("BIGINT", user),
            "url": ("VARCHAR", url),
            "referer": ("VARCHAR", referer),
            "isrefresh": ("INTEGER",
                          (rng.random(n) < 0.1).astype(np.int32)),
            "resolutionwidth": ("INTEGER", np.asarray(
                [1024, 1280, 1366, 1440, 1536, 1600, 1920, 2560])[
                rng.integers(0, 8, n)].astype(np.int32)),
            "mobilephone": ("INTEGER", rng.integers(0, 8, n).astype(np.int32)),
            "mobilephonemodel": ("VARCHAR", np.asarray(MODELS, dtype=object)[
                rng.integers(0, len(MODELS), n)]),
            "traficsourceid": ("INTEGER",
                               rng.integers(-1, 10, n).astype(np.int32)),
            "searchengineid": ("INTEGER",
                               rng.integers(0, 6, n).astype(np.int32)),
            "searchphrase": ("VARCHAR", np.asarray(PHRASES, dtype=object)[
                rng.integers(0, len(PHRASES), n)]),
            "advengineid": ("INTEGER", np.where(
                rng.random(n) < 0.92, 0,
                rng.integers(1, 20, n)).astype(np.int32)),
            "windowclientwidth": ("INTEGER", np.asarray(
                [0, 800, 1024, 1280, 1600, 1920])[
                rng.integers(0, 6, n)].astype(np.int32)),
            "windowclientheight": ("INTEGER", np.asarray(
                [0, 600, 768, 900, 1080])[
                rng.integers(0, 5, n)].astype(np.int32)),
            "islink": ("INTEGER", (rng.random(n) < 0.2).astype(np.int32)),
            "isdownload": ("INTEGER",
                           (rng.random(n) < 0.02).astype(np.int32)),
            "dontcounthits": ("INTEGER",
                              (rng.random(n) < 0.05).astype(np.int32)),
            "urlhash": ("BIGINT", urlhash),
            "refererhash": ("BIGINT", refererhash),
            "ismobile": ("INTEGER", (rng.random(n) < 0.6).astype(np.int32)),
        }
    }


# The 43 queries, reference text (benchmark/clickbench/queries/qNN.sql).
# q30's 90-term SUM sweep is generated programmatically below.
_Q30 = ("SELECT " + ", ".join(
    ["SUM(ResolutionWidth)"]
    + [f"SUM(ResolutionWidth + {i})" for i in range(1, 90)]) + " FROM hits")

QUERIES = {
    1: "SELECT COUNT(*) FROM hits",
    2: "SELECT COUNT(*) FROM hits WHERE AdvEngineID <> 0",
    3: "SELECT SUM(AdvEngineID), COUNT(*), AVG(ResolutionWidth) FROM hits",
    4: "SELECT AVG(UserID) FROM hits",
    5: "SELECT COUNT(DISTINCT UserID) FROM hits",
    6: "SELECT COUNT(DISTINCT SearchPhrase) FROM hits",
    7: "SELECT MIN(EventDate), MAX(EventDate) FROM hits",
    8: ("SELECT AdvEngineID, COUNT(*) FROM hits WHERE AdvEngineID <> 0 "
        "GROUP BY AdvEngineID ORDER BY COUNT(*) DESC, AdvEngineID"),
    9: ("SELECT RegionID, COUNT(DISTINCT UserID) AS u FROM hits "
        "GROUP BY RegionID ORDER BY u DESC, RegionID LIMIT 10"),
    10: ("SELECT RegionID, SUM(AdvEngineID), COUNT(*) AS c, "
         "AVG(ResolutionWidth), COUNT(DISTINCT UserID) FROM hits "
         "GROUP BY RegionID ORDER BY c DESC, RegionID LIMIT 10"),
    11: ("SELECT MobilePhoneModel, COUNT(DISTINCT UserID) AS u FROM hits "
         "WHERE MobilePhoneModel <> '' GROUP BY MobilePhoneModel "
         "ORDER BY u DESC, MobilePhoneModel LIMIT 10"),
    12: ("SELECT MobilePhone, MobilePhoneModel, COUNT(DISTINCT UserID) AS u "
         "FROM hits WHERE MobilePhoneModel <> '' "
         "GROUP BY MobilePhone, MobilePhoneModel "
         "ORDER BY u DESC, MobilePhone, MobilePhoneModel LIMIT 10"),
    13: ("SELECT SearchPhrase, COUNT(*) AS c FROM hits "
         "WHERE SearchPhrase <> '' GROUP BY SearchPhrase "
         "ORDER BY c DESC, SearchPhrase LIMIT 10"),
    14: ("SELECT SearchPhrase, COUNT(DISTINCT UserID) AS u FROM hits "
         "WHERE SearchPhrase <> '' GROUP BY SearchPhrase "
         "ORDER BY u DESC, SearchPhrase LIMIT 10"),
    15: ("SELECT SearchEngineID, SearchPhrase, COUNT(*) AS c FROM hits "
         "WHERE SearchPhrase <> '' GROUP BY SearchEngineID, SearchPhrase "
         "ORDER BY c DESC, SearchEngineID, SearchPhrase LIMIT 10"),
    16: ("SELECT UserID, COUNT(*) FROM hits GROUP BY UserID "
         "ORDER BY COUNT(*) DESC, UserID LIMIT 10"),
    17: ("SELECT UserID, SearchPhrase, COUNT(*) FROM hits "
         "GROUP BY UserID, SearchPhrase "
         "ORDER BY COUNT(*) DESC, UserID, SearchPhrase LIMIT 10"),
    18: ("SELECT UserID, SearchPhrase, COUNT(*) FROM hits "
         "GROUP BY UserID, SearchPhrase ORDER BY UserID, SearchPhrase "
         "LIMIT 10"),
    19: ("SELECT UserID, extract(minute FROM EventTime) AS m, SearchPhrase, "
         "COUNT(*) FROM hits GROUP BY UserID, m, SearchPhrase "
         "ORDER BY COUNT(*) DESC, UserID, m, SearchPhrase LIMIT 10"),
    20: f"SELECT UserID FROM hits WHERE UserID = {PROBE_USERID}",
    21: "SELECT COUNT(*) FROM hits WHERE URL LIKE '%google%'",
    22: ("SELECT SearchPhrase, MIN(URL), COUNT(*) AS c FROM hits "
         "WHERE URL LIKE '%google%' AND SearchPhrase <> '' "
         "GROUP BY SearchPhrase ORDER BY c DESC, SearchPhrase LIMIT 10"),
    23: ("SELECT SearchPhrase, MIN(URL), MIN(Title), COUNT(*) AS c, "
         "COUNT(DISTINCT UserID) FROM hits WHERE Title LIKE '%Google%' "
         "AND URL NOT LIKE '%.google.%' AND SearchPhrase <> '' "
         "GROUP BY SearchPhrase ORDER BY c DESC, SearchPhrase LIMIT 10"),
    24: ("SELECT * FROM hits WHERE URL LIKE '%google%' "
         "ORDER BY EventTime LIMIT 10"),
    25: ("SELECT SearchPhrase FROM hits WHERE SearchPhrase <> '' "
         "ORDER BY EventTime LIMIT 10"),
    26: ("SELECT SearchPhrase FROM hits WHERE SearchPhrase <> '' "
         "ORDER BY SearchPhrase LIMIT 10"),
    27: ("SELECT SearchPhrase FROM hits WHERE SearchPhrase <> '' "
         "ORDER BY EventTime, SearchPhrase LIMIT 10"),
    28: ("SELECT CounterID, AVG(STRLEN(URL)) AS l, COUNT(*) AS c FROM hits "
         "WHERE URL <> '' GROUP BY CounterID HAVING COUNT(*) > 100 "
         "ORDER BY l DESC, CounterID LIMIT 25"),
    29: (r"SELECT REGEXP_REPLACE(Referer, '^https?://(?:www\.)?([^/]+)/.*$',"
         r" '\1') AS k, AVG(STRLEN(Referer)) AS l, COUNT(*) AS c, "
         "MIN(Referer) FROM hits WHERE Referer <> '' GROUP BY k "
         "HAVING COUNT(*) > 100 ORDER BY l DESC, k LIMIT 25"),
    30: _Q30,
    31: ("SELECT SearchEngineID, ClientIP, COUNT(*) AS c, SUM(IsRefresh), "
         "AVG(ResolutionWidth) FROM hits WHERE SearchPhrase <> '' "
         "GROUP BY SearchEngineID, ClientIP "
         "ORDER BY c DESC, SearchEngineID, ClientIP LIMIT 10"),
    32: ("SELECT WatchID, ClientIP, COUNT(*) AS c, SUM(IsRefresh), "
         "AVG(ResolutionWidth) FROM hits WHERE SearchPhrase <> '' "
         "GROUP BY WatchID, ClientIP ORDER BY c DESC, WatchID, ClientIP "
         "LIMIT 10"),
    33: ("SELECT WatchID, ClientIP, COUNT(*) AS c, SUM(IsRefresh), "
         "AVG(ResolutionWidth) FROM hits GROUP BY WatchID, ClientIP "
         "ORDER BY c DESC, WatchID, ClientIP LIMIT 10"),
    34: ("SELECT URL, COUNT(*) AS c FROM hits GROUP BY URL "
         "ORDER BY c DESC, URL LIMIT 10"),
    35: ("SELECT 1, URL, COUNT(*) AS c FROM hits GROUP BY 1, URL "
         "ORDER BY c DESC, URL LIMIT 10"),
    36: ("SELECT ClientIP, ClientIP - 1, ClientIP - 2, ClientIP - 3, "
         "COUNT(*) AS c FROM hits "
         "GROUP BY ClientIP, ClientIP - 1, ClientIP - 2, ClientIP - 3 "
         "ORDER BY c DESC, ClientIP LIMIT 10"),
    37: ("SELECT URL, COUNT(*) AS PageViews FROM hits WHERE CounterID = 62 "
         "AND EventDate >= '2013-07-01' AND EventDate <= '2013-07-31' "
         "AND DontCountHits = 0 AND IsRefresh = 0 AND URL <> '' "
         "GROUP BY URL ORDER BY PageViews DESC, URL LIMIT 10"),
    38: ("SELECT Title, COUNT(*) AS PageViews FROM hits WHERE CounterID = 62 "
         "AND EventDate >= '2013-07-01' AND EventDate <= '2013-07-31' "
         "AND DontCountHits = 0 AND IsRefresh = 0 AND Title <> '' "
         "GROUP BY Title ORDER BY PageViews DESC, Title LIMIT 10"),
    39: ("SELECT URL, COUNT(*) AS PageViews FROM hits WHERE CounterID = 62 "
         "AND EventDate >= '2013-07-01' AND EventDate <= '2013-07-31' "
         "AND IsRefresh = 0 AND IsLink <> 0 AND IsDownload = 0 "
         "GROUP BY URL ORDER BY PageViews DESC, URL LIMIT 10 OFFSET 100"),
    40: ("SELECT TraficSourceID, SearchEngineID, AdvEngineID, "
         "CASE WHEN (SearchEngineID = 0 AND AdvEngineID = 0) THEN Referer "
         "ELSE '' END AS Src, URL AS Dst, COUNT(*) AS PageViews FROM hits "
         "WHERE CounterID = 62 AND EventDate >= '2013-07-01' "
         "AND EventDate <= '2013-07-31' AND IsRefresh = 0 "
         "GROUP BY TraficSourceID, SearchEngineID, AdvEngineID, Src, Dst "
         "ORDER BY PageViews DESC, TraficSourceID, SearchEngineID, "
         "AdvEngineID, Src, Dst LIMIT 10 OFFSET 100"),
    41: ("SELECT URLHash, EventDate, COUNT(*) AS PageViews FROM hits "
         "WHERE CounterID = 62 AND EventDate >= '2013-07-01' "
         "AND EventDate <= '2013-07-31' AND IsRefresh = 0 "
         f"AND TraficSourceID IN (-1, 6) AND RefererHash = {PROBE_REFERERHASH} "
         "GROUP BY URLHash, EventDate "
         "ORDER BY PageViews DESC, URLHash, EventDate LIMIT 10 OFFSET 10"),
    42: ("SELECT WindowClientWidth, WindowClientHeight, COUNT(*) AS PageViews "
         "FROM hits WHERE CounterID = 62 AND EventDate >= '2013-07-01' "
         "AND EventDate <= '2013-07-31' AND IsRefresh = 0 "
         f"AND DontCountHits = 0 AND URLHash = {PROBE_URLHASH} "
         "GROUP BY WindowClientWidth, WindowClientHeight "
         "ORDER BY PageViews DESC, WindowClientWidth, WindowClientHeight "
         "LIMIT 10 OFFSET 10"),
    43: ("SELECT DATE_TRUNC('minute', EventTime) AS M, COUNT(*) AS PageViews "
         "FROM hits WHERE CounterID = 62 AND EventDate >= '2013-07-14' "
         "AND EventDate <= '2013-07-15' AND IsRefresh = 0 "
         "AND DontCountHits = 0 GROUP BY DATE_TRUNC('minute', EventTime) "
         "ORDER BY DATE_TRUNC('minute', EventTime) LIMIT 10 OFFSET 100"),
}

# NOTE vs the reference text: deterministic tiebreak columns are appended
# to ORDER BY clauses (the official set orders by the aggregate alone,
# which is ambiguous under LIMIT); q28/q29's HAVING thresholds scale down
# (100000 over 100M rows -> 100 at this corpus size); q39..q43's OFFSETs
# scale down the same way; the q20/q41/q42 probe constants are planted in
# the synthetic corpus so the lookups return rows.


def _oracle(qid: int) -> str:
    """sqlite translation of a query (dates/timestamps are stored as the
    same integer day/micro values the engine uses)."""
    import re

    sql = QUERIES[qid]
    sql = sql.replace("STRLEN(", "LENGTH(")
    sql = sql.replace("extract(minute FROM EventTime)",
                      "(EventTime / 60000000) % 60")
    sql = sql.replace("DATE_TRUNC('minute', EventTime)",
                      "(EventTime - EventTime % 60000000)")
    # REGEXP_REPLACE is provided to sqlite via create_function (the test
    # registers a Python implementation)
    return sql


ORACLE_QUERIES = {qid: _oracle(qid) for qid in QUERIES}


def prepare_oracle(lite) -> None:
    """Register the scalar functions the oracle translation needs."""
    import re

    def regexp_replace(s, pat, rep):
        if s is None:
            return None
        return re.sub(pat, rep.replace("\\1", "\\g<1>"), s)

    lite.create_function("REGEXP_REPLACE", 3, regexp_replace)


def load_into_engine(con, data: dict) -> None:
    for tname, cols in data.items():
        defs = ", ".join(f"{c} {ty}" for c, (ty, _) in cols.items())
        con.query(f"CREATE TABLE {tname}({defs})")
        app = con.appender(tname)
        app.append_columns({c: arr for c, (_ty, arr) in cols.items()})
        app.close()


def load_into_sqlite(lite, data: dict) -> None:
    """DATE columns are stored as ISO text (lexicographic order == date
    order), matching how the engine renders DATE results."""
    import datetime

    prepare_oracle(lite)
    epoch = datetime.date(1970, 1, 1)
    for tname, cols in data.items():
        names = list(cols)
        lite.execute(f"CREATE TABLE {tname}({', '.join(names)})")
        arrays = []
        for ty, arr in cols.values():
            if ty == "DATE":
                arrays.append([
                    (epoch + datetime.timedelta(days=int(d))).isoformat()
                    for d in arr])
            else:
                arrays.append(arr.tolist())
        lite.executemany(
            f"INSERT INTO {tname} VALUES ({','.join('?' * len(names))})",
            zip(*arrays))
    lite.commit()


def _register_benchmarks():
    from adacom_tpu_torch.bench.runner import Benchmark, register

    class _CBBase(Benchmark):
        qid = 1
        nruns = 3

        def load(self, state):
            import adacom_tpu_torch as at

            db = at.Database(platform=self.platform)
            con = db.connect()
            load_into_engine(con, generate(self.scale))
            db.catalog.get_column_segment_catalog().compact_all_segments()
            state.update(db=db, con=con)

        def run(self, state):
            state["result"] = state["con"].query(QUERIES[self.qid])

        def verify(self, state):
            return None if state["result"].row_count >= 0 else "no result"

    made = []
    for qid in sorted(QUERIES):
        cls = type(f"ClickBench_Q{qid}", (_CBBase,),
                   {"qid": qid, "name": f"ClickBench_Q{qid:02d}"})
        register(cls)
        made.append(cls)
    return made


_register_benchmarks()


def norm_rows(rows) -> list:
    """Rows as tuples of None, str, int or float rounded to 6 places (the
    comparison form of verify_against_oracle)."""
    out = []
    for r in rows:
        row = []
        for v in r:
            if v is None:
                row.append(None)
            elif isinstance(v, float) or (hasattr(v, "dtype")
                                          and "float" in str(v.dtype)):
                row.append(round(float(v), 6))
            elif isinstance(v, str):
                row.append(v)
            else:
                row.append(int(v))
        out.append(tuple(row))
    return out


def answers_equal(qid: int, got_rows, exp_rows) -> bool:
    """Query `qid`'s engine rows against sqlite's: floats within 1e-9,
    all else exact; rows sorted first unless the query orders them."""
    import math

    got, exp = norm_rows(got_rows), norm_rows(exp_rows)
    if "ORDER BY" not in QUERIES[qid]:
        got, exp = sorted(got, key=repr), sorted(exp, key=repr)
    if len(got) != len(exp):
        return False
    for g, e in zip(got, exp):
        if len(g) != len(e):
            return False
        for gv, ev in zip(g, e):
            if isinstance(gv, float) or isinstance(ev, float):
                if gv is None or ev is None or not math.isclose(
                        float(gv), float(ev), rel_tol=1e-9, abs_tol=1e-9):
                    return False
            elif gv != ev:
                return False
    return True


def verify_against_oracle(con, lite, qid: int) -> bool:
    """Row-for-row comparison of query `qid` against the sqlite oracle
    (the reference's answer-CSV verification, benchmark/clickbench/
    answers, over identical synthetic data)."""
    return answers_equal(qid, con.query(QUERIES[qid]).fetchall(),
                         lite.execute(ORACLE_QUERIES[qid]).fetchall())


def sqlite_answers(scale: float) -> dict:
    """Every query's sqlite answer over generate(scale), as lists of
    norm_rows rows, with the seconds each step took (the oracle a run in
    another process compares with; JSON-serialisable)."""
    import sqlite3
    import time

    t0 = time.perf_counter()
    lite = sqlite3.connect(":memory:")
    load_into_sqlite(lite, generate(scale))
    out = {"answers": {}, "seconds": {"load": time.perf_counter() - t0}}
    for qid in sorted(QUERIES):
        t = time.perf_counter()
        rows = lite.execute(ORACLE_QUERIES[qid]).fetchall()
        out["answers"][qid] = [list(r) for r in norm_rows(rows)]
        out["seconds"][f"Q{qid}"] = time.perf_counter() - t
    out["seconds"]["total"] = time.perf_counter() - t0
    lite.close()
    return out
