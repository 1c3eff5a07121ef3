"""TPC-H lineitem (8 columns) and supplier (4 columns) at the configured
scale factor, drawn from the seed by TPC-H 4.2.3's rules (see the JSON
file's "assumed" for where this departs from dbgen).

Decimal columns hold integers at scale 2 and dates days since 1970-01-01,
the form the engine's appender takes."""

from __future__ import annotations

import numpy as np

from benchmark.traffic import rng_for

STARTDATE = int(np.datetime64("1992-01-01", "D").astype(np.int64))
ENDDATE = int(np.datetime64("1998-12-31", "D").astype(np.int64))
CURRENTDATE = int(np.datetime64("1995-06-17", "D").astype(np.int64))
_ALNUM = np.frombuffer(
    b"0123456789abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ", dtype=np.uint8)


def generate(desc: dict, seed: int) -> dict:
    sf = float(desc["scale_factor"])
    rng = rng_for(seed, 0xDA7A)
    n_orders = int(1_500_000 * sf)
    n_part = int(200_000 * sf)
    n_supp = int(10_000 * sf)

    lines = rng.integers(1, 8, n_orders)
    orderdate = STARTDATE + rng.integers(0, ENDDATE - 151 - STARTDATE + 1, n_orders)
    shipdate = np.repeat(orderdate, lines)
    del orderdate
    n = len(shipdate)
    partkey = rng.integers(1, n_part + 1, n)
    corner = rng.integers(0, 4, n)
    suppkey = (partkey + corner * (n_supp // 4 + (partkey - 1) // n_supp)) % n_supp + 1
    del corner
    quantity = rng.integers(1, 51, n)
    retail = 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)
    del partkey
    extendedprice = quantity * retail
    del retail
    discount = rng.integers(0, 11, n)
    tax = rng.integers(0, 9, n)
    shipdate += rng.integers(1, 122, n)
    receiptdate = shipdate + rng.integers(1, 31, n)
    returned = receiptdate <= CURRENTDATE
    del receiptdate
    # string columns as object arrays of str, as an application hands them over
    returnflag = np.array(["N", "A", "R"], dtype=object)[
        np.where(returned, np.where(rng.random(n) < 0.5, 2, 1), 0)]
    linestatus = np.array(["F", "O"], dtype=object)[(shipdate > CURRENTDATE).astype(np.int64)]

    s_suppkey = np.arange(1, n_supp + 1, dtype=np.int64)
    nation = rng.integers(0, 25, n_supp)
    phone = rng.integers([100, 100, 1000], [1000, 1000, 10000], (n_supp, 3))
    alen = rng.integers(10, 41, n_supp)
    chars = _ALNUM[rng.integers(0, len(_ALNUM), int(alen.sum()))].tobytes().decode()
    ends = np.cumsum(alen)
    return {
        "supplier": {
            "s_suppkey": s_suppkey,
            "s_name": np.asarray([f"Supplier#{k:09d}" for k in s_suppkey.tolist()], dtype=object),
            "s_address": np.asarray([chars[e - w:e] for e, w in zip(ends.tolist(), alen.tolist())],
                                    dtype=object),
            "s_phone": np.asarray([f"{10 + k}-{a}-{b}-{c}" for k, (a, b, c)
                                   in zip(nation.tolist(), phone.tolist())], dtype=object),
        },
        "lineitem": {
            "l_quantity": quantity * 100,
            "l_extendedprice": extendedprice,
            "l_discount": discount,
            "l_tax": tax,
            "l_returnflag": returnflag,
            "l_linestatus": linestatus,
            "l_shipdate": shipdate,
            "l_suppkey": suppkey,
        },
    }
