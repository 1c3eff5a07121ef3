"""TPC-H schema, synthetic data generator, and query set.

Port of adacom_tpu/bench/tpch.py (numpy only). Its benchmark registry
(_register_benchmarks) comes with the port of the bench runner (ROADMAP
queue A item 2). ``generate`` draws the same random
stream as the JAX package's, so both packages load identical tables from
one seed; ``generate_lineitem`` draws only what lineitem needs, which
builds the scale-factor-10 table without the Python loops over orders,
parts and customers. Column domains follow the TPC-H spec; the dbgen RNG
streams are not reproduced.

Query texts are the TPC-H formulations (all 22 queries) restricted to the
syntax the engine accepts (plain date strings instead of DATE literals).
``load_into_sqlite`` and ``oracle_sql`` give a sqlite3 oracle on the same
data (the engine-agnostic analogue of the reference's answer files)."""

from __future__ import annotations

import numpy as np

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
INSTRUCTS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]

COLORS = ["almond", "antique", "aquamarine", "azure", "beige", "bisque",
          "black", "blanched", "blue", "blush", "brown", "burlywood",
          "chartreuse", "chiffon", "chocolate", "coral", "cornflower",
          "cream", "cyan", "dark", "deep", "dim", "dodger", "drab", "firebrick",
          "forest", "frosted", "gainsboro", "ghost", "goldenrod", "green",
          "grey", "honeydew", "hot", "hotpink", "indian", "ivory", "khaki",
          "lace", "lavender", "lawn", "lemon", "light", "lime", "linen",
          "magenta", "maroon", "medium", "metallic", "midnight", "mint",
          "misty", "moccasin", "navajo", "navy", "olive", "orange", "orchid",
          "pale", "papaya", "peach", "peru", "pink", "plum", "powder",
          "puff", "purple", "red", "rose", "rosy", "royal", "saddle",
          "salmon", "sandy", "seashell", "sienna", "sky", "slate", "smoke",
          "snow", "spring", "steel", "tan", "thistle", "tomato", "turquoise",
          "violet", "wheat", "white", "yellow"]
WORDS = ["packages", "foxes", "deposits", "accounts", "pinto", "beans",
         "theodolites", "asymptotes", "dependencies", "excuses", "platelets",
         "requests_", "instructions_", "accounts_", "ideas", "dolphins",
         "sheaves", "sauternes", "warthogs", "frets", "dinos"]

_EPOCH_1992 = 8035  # days('1992-01-01')
_DATE_RANGE = 2557  # through 1998-12-31


def _sizes(sf: float):
    """(orders, customers, parts, suppliers) at scale factor `sf`."""
    return (max(64, int(1_500_000 * sf)), max(16, int(150_000 * sf)),
            max(16, int(200_000 * sf)), max(8, int(10_000 * sf)))


def _draw_lineitem(rng, sf: float) -> dict:
    """The orders and lineitem draws of generate(), in its order: the
    orders columns lineitem derives from and the 15 lineitem columns."""
    n_orders, n_cust, n_part, n_supp = _sizes(sf)
    o_orderkey = np.arange(1, n_orders + 1, dtype=np.int64) * 4 - 3
    o_custkey = rng.integers(1, n_cust + 1, n_orders).astype(np.int64)
    o_orderdate = _EPOCH_1992 + rng.integers(0, _DATE_RANGE - 151, n_orders)
    n_lines_per = rng.integers(1, 8, n_orders)
    n_li = int(n_lines_per.sum())
    l_orderkey = np.repeat(o_orderkey, n_lines_per)
    l_linenumber = (np.arange(n_li) -
                    np.repeat(np.concatenate([[0], np.cumsum(n_lines_per)[:-1]]), n_lines_per) + 1)
    l_partkey = rng.integers(1, n_part + 1, n_li).astype(np.int64)
    l_suppkey = ((l_partkey - 1) % n_supp) + 1
    l_quantity = rng.integers(1, 51, n_li).astype(np.int64) * 100  # DECIMAL(12,2)
    retail = 90000 + (l_partkey % 20001) * 10  # part-derived price, scale 2
    l_extendedprice = (l_quantity // 100) * retail
    l_discount = rng.integers(0, 11, n_li).astype(np.int64)  # 0.00-0.10, scale 2
    l_tax = rng.integers(0, 9, n_li).astype(np.int64)
    l_shipdate = np.repeat(o_orderdate, n_lines_per) + rng.integers(1, 122, n_li)
    l_commitdate = np.repeat(o_orderdate, n_lines_per) + rng.integers(30, 91, n_li)
    l_receiptdate = l_shipdate + rng.integers(1, 31, n_li)
    received = l_receiptdate <= (_EPOCH_1992 + _DATE_RANGE - 180)
    l_returnflag = np.where(received,
                            np.where(rng.random(n_li) < 0.5, "R", "A"), "N")
    l_linestatus = np.where(l_shipdate > (_EPOCH_1992 + 1780), "O", "F")
    l_shipmode = np.asarray(SHIPMODES, dtype=object)[rng.integers(0, len(SHIPMODES), n_li)]
    l_shipinstruct = np.asarray(INSTRUCTS, dtype=object)[rng.integers(0, len(INSTRUCTS), n_li)]

    return {
        "n_lines_per": n_lines_per, "o_orderkey": o_orderkey,
        "o_custkey": o_custkey, "o_orderdate": o_orderdate,
        "lineitem": {
            "l_orderkey": l_orderkey, "l_partkey": l_partkey,
            "l_suppkey": l_suppkey.astype(np.int64), "l_linenumber": l_linenumber.astype(np.int64),
            "l_quantity": l_quantity, "l_extendedprice": l_extendedprice,
            "l_discount": l_discount, "l_tax": l_tax,
            "l_returnflag": l_returnflag.astype(object), "l_linestatus": l_linestatus.astype(object),
            "l_shipdate": l_shipdate.astype(np.int64), "l_commitdate": l_commitdate.astype(np.int64),
            "l_receiptdate": l_receiptdate.astype(np.int64),
            "l_shipinstruct": l_shipinstruct, "l_shipmode": l_shipmode,
        },
    }


def generate_lineitem(sf: float = 0.01, seed: int = 19920701) -> dict:
    """The lineitem table of generate(sf, seed) alone, as a numpy dict."""
    return _draw_lineitem(np.random.default_rng(seed), sf)["lineitem"]


def generate(sf: float = 0.01, seed: int = 19920701) -> dict:
    """Generate all 8 TPC-H tables at scale factor `sf` as numpy dicts."""
    rng = np.random.default_rng(seed)
    n_orders, n_cust, n_part, n_supp = _sizes(sf)
    li = _draw_lineitem(rng, sf)
    n_lines_per, o_orderkey = li["n_lines_per"], li["o_orderkey"]
    o_custkey, o_orderdate = li["o_custkey"], li["o_orderdate"]
    l_extendedprice = li["lineitem"]["l_extendedprice"]
    l_linestatus = li["lineitem"]["l_linestatus"]

    # order totals derived from lineitems
    ext_sum = np.zeros(n_orders, np.int64)
    np.add.at(ext_sum, np.repeat(np.arange(n_orders), n_lines_per), l_extendedprice)
    o_totalprice = ext_sum
    # status: F if all lines F, O if all O, else P
    all_f = np.ones(n_orders, bool)
    any_f = np.zeros(n_orders, bool)
    oidx = np.repeat(np.arange(n_orders), n_lines_per)
    line_f = l_linestatus == "F"
    np.logical_and.at(all_f, oidx, line_f)
    np.logical_or.at(any_f, oidx, line_f)
    o_orderstatus = np.where(all_f, "F", np.where(any_f, "P", "O"))
    o_orderpriority = np.asarray(PRIORITIES, dtype=object)[rng.integers(0, 5, n_orders)]
    o_clerk = np.asarray([f"Clerk#{i:09d}" for i in rng.integers(1, 1001, n_orders)], dtype=object)

    # o_comment: ~5 % contain the Q13 '%special%requests%' phrase
    o_comment = np.asarray(
        [f"{WORDS[i % len(WORDS)]} special {WORDS[(i * 7) % len(WORDS)]} requests pending"
         if m else f"{WORDS[i % len(WORDS)]} {WORDS[(i * 3 + 1) % len(WORDS)]} instructions"
         for i, m in enumerate(rng.random(n_orders) < 0.05)], dtype=object)

    # customer / supplier / nation / region / part / partsupp
    c_custkey = np.arange(1, n_cust + 1, dtype=np.int64)
    c_nationkey = rng.integers(0, 25, n_cust).astype(np.int64)
    c_mktsegment = np.asarray(SEGMENTS, dtype=object)[rng.integers(0, 5, n_cust)]
    c_acctbal = rng.integers(-99999, 999999, n_cust).astype(np.int64)
    c_name = np.asarray([f"Customer#{k:09d}" for k in c_custkey], dtype=object)
    c_address = np.asarray([WORDS[(k * 13) % len(WORDS)] for k in c_custkey], dtype=object)
    # phone country code = 10 + nationkey (TPC-H spec; Q22 keys on it)
    c_phone = np.asarray(
        [f"{10 + nk}-{100 + (k * 7) % 900}-{100 + (k * 31) % 900}-{1000 + (k * 17) % 9000}"
         for k, nk in zip(c_custkey, c_nationkey)], dtype=object)
    c_comment = np.asarray([WORDS[(k * 5 + 2) % len(WORDS)] for k in c_custkey], dtype=object)

    s_suppkey = np.arange(1, n_supp + 1, dtype=np.int64)
    s_nationkey = rng.integers(0, 25, n_supp).astype(np.int64)
    s_acctbal = rng.integers(-99999, 999999, n_supp).astype(np.int64)
    s_name = np.asarray([f"Supplier#{k:09d}" for k in s_suppkey], dtype=object)
    s_address = np.asarray([WORDS[(k * 11) % len(WORDS)] for k in s_suppkey], dtype=object)
    s_phone = np.asarray(
        [f"{10 + nk}-{100 + (k * 7) % 900}-{100 + (k * 31) % 900}-{1000 + (k * 17) % 9000}"
         for k, nk in zip(s_suppkey, s_nationkey)], dtype=object)
    # ~3 % match Q16's '%Customer%Complaints%'
    s_comment = np.asarray(
        [f"{WORDS[k % len(WORDS)]} Customer unhappy Complaints filed"
         if m else f"{WORDS[k % len(WORDS)]} reliable {WORDS[(k * 3) % len(WORDS)]}"
         for k, m in zip(s_suppkey, rng.random(n_supp) < 0.03)], dtype=object)

    p_partkey = np.arange(1, n_part + 1, dtype=np.int64)
    p_name = np.asarray(
        [f"{COLORS[rng.integers(0, len(COLORS))]} {COLORS[rng.integers(0, len(COLORS))]}"
         for _ in range(n_part)], dtype=object)
    p_mfgr = np.asarray([f"Manufacturer#{1 + k % 5}" for k in p_partkey], dtype=object)
    p_type = np.asarray(
        [f"{TYPE_S1[rng.integers(0, 6)]} {TYPE_S2[rng.integers(0, 5)]} {TYPE_S3[rng.integers(0, 5)]}"
         for _ in range(n_part)], dtype=object)
    p_size = rng.integers(1, 51, n_part).astype(np.int64)
    p_brand = np.asarray([f"Brand#{rng.integers(1, 6)}{rng.integers(1, 6)}"
                          for _ in range(n_part)], dtype=object)
    p_container = np.asarray(
        [f"{a} {b}" for a, b in zip(
            np.asarray(["SM", "LG", "MED", "JUMBO", "WRAP"], dtype=object)[rng.integers(0, 5, n_part)],
            np.asarray(["CASE", "BOX", "BAG", "JAR", "PACK", "PKG", "CAN", "DRUM"], dtype=object)[rng.integers(0, 8, n_part)],
        )], dtype=object)
    p_retailprice = 90000 + (p_partkey % 20001) * 10

    ps_rows = n_part * 4
    ps_partkey = np.repeat(p_partkey, 4)
    ps_suppkey = ((ps_partkey - 1 + np.tile(np.arange(4), n_part) * (n_supp // 4 + 1)) % n_supp) + 1
    ps_availqty = rng.integers(1, 10000, ps_rows).astype(np.int64)
    ps_supplycost = rng.integers(100, 100001, ps_rows).astype(np.int64)

    return {
        "lineitem": li["lineitem"],
        "orders": {
            "o_orderkey": o_orderkey, "o_custkey": o_custkey,
            "o_orderstatus": o_orderstatus.astype(object), "o_totalprice": o_totalprice,
            "o_orderdate": o_orderdate.astype(np.int64),
            "o_orderpriority": o_orderpriority, "o_clerk": o_clerk,
            "o_shippriority": np.zeros(n_orders, np.int64),
            "o_comment": o_comment,
        },
        "customer": {
            "c_custkey": c_custkey, "c_name": c_name,
            "c_address": c_address, "c_nationkey": c_nationkey,
            "c_phone": c_phone, "c_acctbal": c_acctbal,
            "c_mktsegment": c_mktsegment, "c_comment": c_comment,
        },
        "supplier": {
            "s_suppkey": s_suppkey, "s_name": s_name,
            "s_address": s_address, "s_nationkey": s_nationkey,
            "s_phone": s_phone, "s_acctbal": s_acctbal,
            "s_comment": s_comment,
        },
        "nation": {
            "n_nationkey": np.arange(25, dtype=np.int64),
            "n_name": np.asarray([n for n, _ in NATIONS], dtype=object),
            "n_regionkey": np.asarray([r for _, r in NATIONS], dtype=np.int64),
        },
        "region": {
            "r_regionkey": np.arange(5, dtype=np.int64),
            "r_name": np.asarray(REGIONS, dtype=object),
        },
        "part": {
            "p_partkey": p_partkey, "p_name": p_name, "p_mfgr": p_mfgr,
            "p_brand": p_brand, "p_type": p_type, "p_size": p_size,
            "p_container": p_container, "p_retailprice": p_retailprice,
        },
        "partsupp": {
            "ps_partkey": ps_partkey, "ps_suppkey": ps_suppkey.astype(np.int64),
            "ps_availqty": ps_availqty, "ps_supplycost": ps_supplycost,
        },
    }


DDL = {
    "lineitem": (
        "CREATE TABLE lineitem(l_orderkey BIGINT, l_partkey BIGINT, "
        "l_suppkey BIGINT, l_linenumber BIGINT, l_quantity DECIMAL(12,2), "
        "l_extendedprice DECIMAL(12,2), l_discount DECIMAL(12,2), "
        "l_tax DECIMAL(12,2), l_returnflag VARCHAR, l_linestatus VARCHAR, "
        "l_shipdate DATE, l_commitdate DATE, l_receiptdate DATE, "
        "l_shipinstruct VARCHAR, l_shipmode VARCHAR)"
    ),
    "orders": (
        "CREATE TABLE orders(o_orderkey BIGINT, o_custkey BIGINT, "
        "o_orderstatus VARCHAR, o_totalprice DECIMAL(12,2), o_orderdate DATE, "
        "o_orderpriority VARCHAR, o_clerk VARCHAR, o_shippriority BIGINT, "
        "o_comment VARCHAR)"
    ),
    "customer": (
        "CREATE TABLE customer(c_custkey BIGINT, c_name VARCHAR, "
        "c_address VARCHAR, c_nationkey BIGINT, c_phone VARCHAR, "
        "c_acctbal DECIMAL(12,2), c_mktsegment VARCHAR, c_comment VARCHAR)"
    ),
    "supplier": (
        "CREATE TABLE supplier(s_suppkey BIGINT, s_name VARCHAR, "
        "s_address VARCHAR, s_nationkey BIGINT, s_phone VARCHAR, "
        "s_acctbal DECIMAL(12,2), s_comment VARCHAR)"
    ),
    "nation": "CREATE TABLE nation(n_nationkey BIGINT, n_name VARCHAR, n_regionkey BIGINT)",
    "region": "CREATE TABLE region(r_regionkey BIGINT, r_name VARCHAR)",
    "part": (
        "CREATE TABLE part(p_partkey BIGINT, p_name VARCHAR, p_mfgr VARCHAR, "
        "p_brand VARCHAR, p_type VARCHAR, p_size BIGINT, "
        "p_container VARCHAR, p_retailprice DECIMAL(12,2))"
    ),
    "partsupp": (
        "CREATE TABLE partsupp(ps_partkey BIGINT, ps_suppkey BIGINT, "
        "ps_availqty BIGINT, ps_supplycost DECIMAL(12,2))"
    ),
}


# decimal-typed columns carry scale-2 integers in the generated arrays
_DECIMAL_COLS = {
    "l_quantity", "l_extendedprice", "l_discount", "l_tax", "o_totalprice",
    "c_acctbal", "s_acctbal", "p_retailprice", "ps_supplycost",
}
_DATE_COLS = {"l_shipdate", "l_commitdate", "l_receiptdate", "o_orderdate"}


def _dstr(days_since_epoch: np.ndarray) -> np.ndarray:
    """Days since 1970-01-01 -> ISO date strings."""
    return np.datetime_as_string(
        np.asarray(days_since_epoch, np.int64).astype("datetime64[D]"))


def load_into_engine(con, data: dict) -> None:
    """Create and fill each table of `data` (decimal columns carry
    scale-2 integers, dates days since the epoch)."""
    for tname, cols in data.items():
        con.query(DDL[tname])
        app = con.appender(tname)
        app.append_columns(dict(cols))
        app.close()


def load_into_sqlite(lite, data: dict) -> None:
    """The same tables in a sqlite3 connection: decimals as REAL, dates
    as ISO TEXT."""
    for tname, cols in data.items():
        names = list(cols)
        decls = ", ".join(
            f"{c} {'REAL' if c in _DECIMAL_COLS else ('TEXT' if cols[c].dtype == object or c in _DATE_COLS else 'INTEGER')}"
            for c in names
        )
        lite.execute(f"CREATE TABLE {tname}({decls})")
        arrays = []
        for c in names:
            v = cols[c]
            if c in _DECIMAL_COLS:
                arrays.append((v / 100.0).tolist())
            elif c in _DATE_COLS:
                arrays.append(_dstr(v).tolist())
            else:
                arrays.append(v.tolist())
        lite.executemany(
            f"INSERT INTO {tname} VALUES ({','.join('?' * len(names))})",
            zip(*arrays),
        )
    lite.commit()


QUERIES = {
    1: """
SELECT l_returnflag, l_linestatus,
       sum(l_quantity) AS sum_qty,
       sum(l_extendedprice) AS sum_base_price,
       sum(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
       sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge,
       avg(l_quantity) AS avg_qty,
       avg(l_extendedprice) AS avg_price,
       avg(l_discount) AS avg_disc,
       count(*) AS count_order
FROM lineitem
WHERE l_shipdate <= '1998-09-02'
GROUP BY l_returnflag, l_linestatus
ORDER BY l_returnflag, l_linestatus
""",
    3: """
SELECT l_orderkey,
       sum(l_extendedprice * (1 - l_discount)) AS revenue,
       o_orderdate, o_shippriority
FROM customer, orders, lineitem
WHERE c_mktsegment = 'BUILDING'
  AND c_custkey = o_custkey
  AND l_orderkey = o_orderkey
  AND o_orderdate < '1995-03-15'
  AND l_shipdate > '1995-03-15'
GROUP BY l_orderkey, o_orderdate, o_shippriority
ORDER BY revenue DESC, o_orderdate
LIMIT 10
""",
    5: """
SELECT n_name, sum(l_extendedprice * (1 - l_discount)) AS revenue
FROM customer, orders, lineitem, supplier, nation, region
WHERE c_custkey = o_custkey AND l_orderkey = o_orderkey
  AND l_suppkey = s_suppkey AND c_nationkey = s_nationkey
  AND s_nationkey = n_nationkey AND n_regionkey = r_regionkey
  AND r_name = 'ASIA'
  AND o_orderdate >= '1994-01-01' AND o_orderdate < '1995-01-01'
GROUP BY n_name
ORDER BY revenue DESC
""",
    6: """
SELECT sum(l_extendedprice * l_discount) AS revenue
FROM lineitem
WHERE l_shipdate >= '1994-01-01' AND l_shipdate < '1995-01-01'
  AND l_discount BETWEEN 0.05 AND 0.07
  AND l_quantity < 24
""",
    10: """
SELECT c_custkey, sum(l_extendedprice * (1 - l_discount)) AS revenue,
       c_acctbal, n_name
FROM customer, orders, lineitem, nation
WHERE c_custkey = o_custkey AND l_orderkey = o_orderkey
  AND o_orderdate >= '1993-10-01' AND o_orderdate < '1994-01-01'
  AND l_returnflag = 'R' AND c_nationkey = n_nationkey
GROUP BY c_custkey, c_acctbal, n_name
ORDER BY revenue DESC
LIMIT 20
""",
    12: """
SELECT l_shipmode,
       sum(CASE WHEN o_orderpriority = '1-URGENT' OR o_orderpriority = '2-HIGH'
                THEN 1 ELSE 0 END) AS high_line_count,
       sum(CASE WHEN o_orderpriority <> '1-URGENT' AND o_orderpriority <> '2-HIGH'
                THEN 1 ELSE 0 END) AS low_line_count
FROM orders, lineitem
WHERE o_orderkey = l_orderkey
  AND l_shipmode IN ('MAIL', 'SHIP')
  AND l_commitdate < l_receiptdate AND l_shipdate < l_commitdate
  AND l_receiptdate >= '1994-01-01' AND l_receiptdate < '1995-01-01'
GROUP BY l_shipmode
ORDER BY l_shipmode
""",
    14: """
SELECT 100.00 * sum(CASE WHEN p_type LIKE 'PROMO%'
                         THEN l_extendedprice * (1 - l_discount)
                         ELSE 0 END) / sum(l_extendedprice * (1 - l_discount)) AS promo_revenue
FROM lineitem, part
WHERE l_partkey = p_partkey
  AND l_shipdate >= '1995-09-01' AND l_shipdate < '1995-10-01'
""",
    18: """
SELECT c_custkey, o_orderkey, o_orderdate, o_totalprice, sum(l_quantity)
FROM customer, orders, lineitem
WHERE o_orderkey IN (SELECT l_orderkey FROM lineitem
                     GROUP BY l_orderkey HAVING sum(l_quantity) > 300)
  AND c_custkey = o_custkey AND o_orderkey = l_orderkey
GROUP BY c_custkey, o_orderkey, o_orderdate, o_totalprice
ORDER BY o_totalprice DESC, o_orderdate
LIMIT 100
""",
    19: """
SELECT sum(l_extendedprice * (1 - l_discount)) AS revenue
FROM lineitem, part
WHERE p_partkey = l_partkey
  AND ((p_brand = 'Brand#12' AND l_quantity >= 1 AND l_quantity <= 11 AND p_size BETWEEN 1 AND 5)
    OR (p_brand = 'Brand#23' AND l_quantity >= 10 AND l_quantity <= 20 AND p_size BETWEEN 1 AND 10)
    OR (p_brand = 'Brand#34' AND l_quantity >= 20 AND l_quantity <= 30 AND p_size BETWEEN 1 AND 15))
""",
    2: """
SELECT s_acctbal, s_name, n_name, p_partkey, p_mfgr, s_address, s_phone, s_comment
FROM part, supplier, partsupp, nation, region
WHERE p_partkey = ps_partkey AND s_suppkey = ps_suppkey
  AND p_size = 15 AND p_type LIKE '%BRASS'
  AND s_nationkey = n_nationkey AND n_regionkey = r_regionkey
  AND r_name = 'EUROPE'
  AND ps_supplycost = (SELECT min(ps_supplycost)
                       FROM partsupp, supplier, nation, region
                       WHERE p_partkey = ps_partkey AND s_suppkey = ps_suppkey
                         AND s_nationkey = n_nationkey
                         AND n_regionkey = r_regionkey AND r_name = 'EUROPE')
ORDER BY s_acctbal DESC, n_name, s_name, p_partkey
LIMIT 100
""",
    4: """
SELECT o_orderpriority, count(*) AS order_count
FROM orders
WHERE o_orderdate >= '1993-07-01' AND o_orderdate < '1993-10-01'
  AND EXISTS (SELECT * FROM lineitem
              WHERE l_orderkey = o_orderkey AND l_commitdate < l_receiptdate)
GROUP BY o_orderpriority
ORDER BY o_orderpriority
""",
    7: """
SELECT supp_nation, cust_nation, l_year, sum(volume) AS revenue
FROM (SELECT n1.n_name AS supp_nation, n2.n_name AS cust_nation,
             EXTRACT(year FROM l_shipdate) AS l_year,
             l_extendedprice * (1 - l_discount) AS volume
      FROM supplier, lineitem, orders, customer, nation n1, nation n2
      WHERE s_suppkey = l_suppkey AND o_orderkey = l_orderkey
        AND c_custkey = o_custkey
        AND s_nationkey = n1.n_nationkey AND c_nationkey = n2.n_nationkey
        AND ((n1.n_name = 'FRANCE' AND n2.n_name = 'GERMANY')
          OR (n1.n_name = 'GERMANY' AND n2.n_name = 'FRANCE'))
        AND l_shipdate BETWEEN '1995-01-01' AND '1996-12-31') AS shipping
GROUP BY supp_nation, cust_nation, l_year
ORDER BY supp_nation, cust_nation, l_year
""",
    8: """
SELECT o_year,
       sum(CASE WHEN nation = 'BRAZIL' THEN volume ELSE 0 END) / sum(volume) AS mkt_share
FROM (SELECT EXTRACT(year FROM o_orderdate) AS o_year,
             l_extendedprice * (1 - l_discount) AS volume,
             n2.n_name AS nation
      FROM part, supplier, lineitem, orders, customer, nation n1, nation n2, region
      WHERE p_partkey = l_partkey AND s_suppkey = l_suppkey
        AND l_orderkey = o_orderkey AND o_custkey = c_custkey
        AND c_nationkey = n1.n_nationkey AND n1.n_regionkey = r_regionkey
        AND r_name = 'AMERICA' AND s_nationkey = n2.n_nationkey
        AND o_orderdate BETWEEN '1995-01-01' AND '1996-12-31'
        AND p_type = 'ECONOMY ANODIZED STEEL') AS all_nations
GROUP BY o_year
ORDER BY o_year
""",
    9: """
SELECT nation, o_year, sum(amount) AS sum_profit
FROM (SELECT n_name AS nation, EXTRACT(year FROM o_orderdate) AS o_year,
             l_extendedprice * (1 - l_discount) - ps_supplycost * l_quantity AS amount
      FROM part, supplier, lineitem, partsupp, orders, nation
      WHERE s_suppkey = l_suppkey AND ps_suppkey = l_suppkey
        AND ps_partkey = l_partkey AND p_partkey = l_partkey
        AND o_orderkey = l_orderkey AND s_nationkey = n_nationkey
        AND p_name LIKE '%green%') AS profit
GROUP BY nation, o_year
ORDER BY nation, o_year DESC
""",
    11: """
SELECT ps_partkey, sum(ps_supplycost * ps_availqty) AS value
FROM partsupp, supplier, nation
WHERE ps_suppkey = s_suppkey AND s_nationkey = n_nationkey
  AND n_name = 'GERMANY'
GROUP BY ps_partkey
HAVING sum(ps_supplycost * ps_availqty) >
       (SELECT sum(ps_supplycost * ps_availqty) * 0.0001
        FROM partsupp, supplier, nation
        WHERE ps_suppkey = s_suppkey AND s_nationkey = n_nationkey
          AND n_name = 'GERMANY')
ORDER BY value DESC
""",
    13: """
SELECT c_count, count(*) AS custdist
FROM (SELECT c_custkey, count(o_orderkey) AS c_count
      FROM customer LEFT OUTER JOIN orders
        ON c_custkey = o_custkey AND o_comment NOT LIKE '%special%requests%'
      GROUP BY c_custkey) AS c_orders
GROUP BY c_count
ORDER BY custdist DESC, c_count DESC
""",
    15: """
WITH revenue AS (SELECT l_suppkey AS supplier_no,
                        sum(l_extendedprice * (1 - l_discount)) AS total_revenue
                 FROM lineitem
                 WHERE l_shipdate >= '1996-01-01' AND l_shipdate < '1996-04-01'
                 GROUP BY l_suppkey)
SELECT s_suppkey, s_name, s_address, s_phone, total_revenue
FROM supplier, revenue
WHERE s_suppkey = supplier_no
  AND total_revenue = (SELECT max(total_revenue) FROM revenue)
ORDER BY s_suppkey
""",
    16: """
SELECT p_brand, p_type, p_size, count(DISTINCT ps_suppkey) AS supplier_cnt
FROM partsupp, part
WHERE p_partkey = ps_partkey
  AND p_brand <> 'Brand#45'
  AND p_type NOT LIKE 'MEDIUM POLISHED%'
  AND p_size IN (49, 14, 23, 45, 19, 3, 36, 9)
  AND ps_suppkey NOT IN (SELECT s_suppkey FROM supplier
                         WHERE s_comment LIKE '%Customer%Complaints%')
GROUP BY p_brand, p_type, p_size
ORDER BY supplier_cnt DESC, p_brand, p_type, p_size
""",
    17: """
SELECT sum(l_extendedprice) / 7.0 AS avg_yearly
FROM lineitem, part
WHERE p_partkey = l_partkey
  AND p_brand = 'Brand#23' AND p_container = 'MED BOX'
  AND l_quantity < (SELECT 0.2 * avg(l_quantity) FROM lineitem
                    WHERE l_partkey = p_partkey)
""",
    20: """
SELECT s_name, s_address
FROM supplier, nation
WHERE s_suppkey IN (SELECT ps_suppkey FROM partsupp
                    WHERE ps_partkey IN (SELECT p_partkey FROM part
                                         WHERE p_name LIKE 'forest%')
                      AND ps_availqty > (SELECT 0.5 * sum(l_quantity)
                                         FROM lineitem
                                         WHERE l_partkey = ps_partkey
                                           AND l_suppkey = ps_suppkey
                                           AND l_shipdate >= '1994-01-01'
                                           AND l_shipdate < '1995-01-01'))
  AND s_nationkey = n_nationkey AND n_name = 'CANADA'
ORDER BY s_name
""",
    21: """
SELECT s_name, count(*) AS numwait
FROM supplier, lineitem l1, orders, nation
WHERE s_suppkey = l1.l_suppkey AND o_orderkey = l1.l_orderkey
  AND o_orderstatus = 'F' AND l1.l_receiptdate > l1.l_commitdate
  AND EXISTS (SELECT * FROM lineitem l2
              WHERE l2.l_orderkey = l1.l_orderkey
                AND l2.l_suppkey <> l1.l_suppkey)
  AND NOT EXISTS (SELECT * FROM lineitem l3
                  WHERE l3.l_orderkey = l1.l_orderkey
                    AND l3.l_suppkey <> l1.l_suppkey
                    AND l3.l_receiptdate > l3.l_commitdate)
  AND s_nationkey = n_nationkey AND n_name = 'SAUDI ARABIA'
GROUP BY s_name
ORDER BY numwait DESC, s_name
LIMIT 100
""",
    22: """
SELECT cntrycode, count(*) AS numcust, sum(c_acctbal) AS totacctbal
FROM (SELECT substring(c_phone, 1, 2) AS cntrycode, c_acctbal
      FROM customer
      WHERE substring(c_phone, 1, 2) IN ('13', '31', '23', '29', '30', '18', '17')
        AND c_acctbal > (SELECT avg(c_acctbal) FROM customer
                         WHERE c_acctbal > 0.00
                           AND substring(c_phone, 1, 2) IN
                               ('13', '31', '23', '29', '30', '18', '17'))
        AND NOT EXISTS (SELECT * FROM orders WHERE o_custkey = c_custkey)) AS custsale
GROUP BY cntrycode
ORDER BY cntrycode
""",
}

# sqlite-oracle variants for queries whose engine syntax sqlite lacks
# (EXTRACT(year FROM d) -> strftime)
ORACLE_QUERIES = {
    qid: QUERIES[qid].replace(
        "EXTRACT(year FROM l_shipdate)",
        "CAST(strftime('%Y', l_shipdate) AS INTEGER)",
    ).replace(
        "EXTRACT(year FROM o_orderdate)",
        "CAST(strftime('%Y', o_orderdate) AS INTEGER)",
    )
    for qid in (7, 8, 9)
}


def oracle_sql(qid: int) -> str:
    return ORACLE_QUERIES.get(qid, QUERIES[qid])
