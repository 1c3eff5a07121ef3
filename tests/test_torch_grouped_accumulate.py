"""A dense GROUP BY's chunks added into a scan's running accumulators in
place (adacom_tpu_torch.ops.agg grouped_accumulate) and its kernel,
csrc/grouped_accumulate.cu.

On the CPU: the wrapper runs its plain version, which over several chunks
equals each chunk's grouped_partial merged by merge_partials, for every
kind and accumulator dtype the generic path makes, at domains of 1, 7 and
5,000, with an all-rejected chunk, an empty chunk and a multi-key
mixed-radix domain; the generic path's _agg_partials, with NULL keys and
NULL arguments, equals the per-spec partials it used to merge; a GROUP BY
with NULLs answers as a NumPy reference; the kernel wrapper's checks raise
before any launch; the "scatter" launch count stays 0 and `agg.partials`
counts no kernel.

On a card (marker `card`; these skip without one): the kernel equals the
plain version bit for bit on integer kinds and within the bound of either
summation order on float sums (|error| <= (n - 1) eps sum|x| per group for
each order, so twice that between the two), at the revenue chunk shape
(2^24 rows, 100,000 groups, 1 row in 28 kept), at domains of 1, 7 and 1,000
and on both sides of the shared-memory threshold; the revenue GROUP BY on
`platform="cuda"` answers as the host aggregate with one launch a chunk.
This file imports nothing of JAX, so it runs on a machine with a card and
no JAX: `python3 -m pytest --noconftest -p no:cacheprovider -q -m card
tests/test_torch_grouped_accumulate.py`."""

import numpy as np
import pytest
import torch

import adacom_tpu_torch
from adacom_tpu_torch import tools
from adacom_tpu_torch.exec import device_scan
from adacom_tpu_torch.ops import agg

KINDS = ("count", "sum", "sumsq", "min", "max")
SMEM_BYTES = 40 * 1024  # csrc/grouped_accumulate.cu kSmemBytes


@pytest.fixture
def card():
    """The first CUDA device; skips where torch finds none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; torch finds none")
    return torch.device("cuda", 0)


def _values(rng, n, acc):
    if np.dtype(acc).kind == "f":
        return rng.standard_normal(n) * 1e6
    return rng.integers(-(1 << 20), 1 << 20, n)  # sumsq stays inside int64


def _chunks(rng, n_chunks, n, domain, acc, keep=0.7):
    """Per chunk (gid, mask, values) as numpy arrays."""
    return [(rng.integers(0, domain, n), rng.random(n) < keep, _values(rng, n, acc))
            for _ in range(n_chunks)]


def _specs(values, acc, dev, kinds=KINDS):
    v = torch.from_numpy(values).to(dev)
    return [(k, None if k == "count" else v, acc) for k in kinds]


def _per_chunk_merged(chunks, domain, acc, kinds=KINDS):
    """The scan's partials as the generic path made them before: each
    chunk's grouped_partial, merged into the running ones by
    merge_partials."""
    out = None
    for gid, mask, values in chunks:
        parts = agg.grouped_partial(torch.from_numpy(gid), torch.from_numpy(mask),
                                    _specs(values, acc, "cpu", kinds), domain)
        out = list(parts) if out is None else [
            agg.merge_partials(k, a, p) for k, a, p in zip(kinds, out, parts)]
    return out


def _accumulated(chunks, domain, acc, dev="cpu", kinds=KINDS):
    accs = agg.new_accumulators([(k, acc) for k in kinds], domain, dev)
    ran = []
    for gid, mask, values in chunks:
        ran.append(agg.grouped_accumulate(
            accs, torch.from_numpy(gid).to(dev), torch.from_numpy(mask).to(dev),
            _specs(values, acc, dev, kinds)))
    return accs, ran


@pytest.mark.parametrize("domain", [1, 7, 5000])
@pytest.mark.parametrize("acc", [np.int64, np.float64])
def test_accumulate_in_place_equals_per_chunk_partials(domain, acc):
    rng = np.random.default_rng(domain)
    chunks = _chunks(rng, 3, 4099, domain, acc)
    accs, ran = _accumulated(chunks, domain, acc)
    assert ran == [(0, 0)] * 3  # the plain version: no kernel
    want = _per_chunk_merged(chunks, domain, acc)
    for kind, got, w in zip(KINDS, accs, want):
        assert got.dtype == w.dtype and tuple(got.shape) == (domain,), kind
        # the same scatters in the same order, merged the same way: exact
        assert torch.equal(got, w), kind


@pytest.mark.parametrize("acc", [np.int64, np.float64])
def test_an_all_rejected_chunk_and_an_empty_one_change_nothing(acc):
    rng = np.random.default_rng(3)
    domain = 11
    chunks = _chunks(rng, 2, 500, domain, acc)
    gid, _mask, values = _chunks(rng, 1, 500, domain, acc)[0]
    chunks.insert(1, (gid, np.zeros(500, bool), values))
    chunks.append((np.zeros(0, np.int64), np.zeros(0, bool), _values(rng, 0, acc)))
    accs, _ran = _accumulated(chunks, domain, acc)
    want = _per_chunk_merged(chunks[:1] + chunks[2:3], domain, acc)
    for kind, got, w in zip(KINDS, accs, want):
        assert torch.equal(got, w), kind
    # a scan whose every row is rejected keeps the starting values
    fresh, _ran = _accumulated(chunks[1:2], domain, acc)
    for kind, got, start in zip(KINDS, fresh, agg.new_accumulators(
            [(k, acc) for k in KINDS], domain, "cpu")):
        assert torch.equal(got, start), kind


def test_multi_key_mixed_radix_domain():
    """Two keys through dense_group_ids (mins -3 and 100, strides 40 and 1)
    into a 480-slot domain, accumulated in place, against a NumPy tally."""
    rng = np.random.default_rng(9)
    mins, strides, domain = [-3, 100], [40, 1], 12 * 40
    accs = agg.new_accumulators([("count", np.int64), ("sum", np.int64)], domain, "cpu")
    want_n, want_s = np.zeros(domain, np.int64), np.zeros(domain, np.int64)
    for _ in range(3):
        a = rng.integers(-3, 9, 3000).astype(np.int32)
        c = rng.integers(100, 140, 3000)
        m = rng.random(3000) < 0.5
        v = rng.integers(-1000, 1000, 3000)
        gid = agg.dense_group_ids([torch.from_numpy(a), torch.from_numpy(c)],
                                  mins, strides, domain)
        agg.grouped_accumulate(accs, gid, torch.from_numpy(m),
                               [("count", None, np.int64),
                                ("sum", torch.from_numpy(v), np.int64)])
        g = (a.astype(np.int64) + 3) * 40 + (c - 100)
        np.add.at(want_n, g[m], 1)
        np.add.at(want_s, g[m], v[m])
    np.testing.assert_array_equal(accs[0].numpy(), want_n)
    np.testing.assert_array_equal(accs[1].numpy(), want_s)


def _old_chunk_partials(cols, mask, params, spec_entries, group_fns, dense):
    """One chunk's partials as the generic path made them before in-place
    accumulation: a grouped_partial per spec, NULL arguments made neutral,
    a count of the argument as a sum of ones."""
    n = mask.shape[0]
    mins, strides, sizes, domain, nullable = dense
    keys = []
    for gf, mn, size, can_null in zip(group_fns, mins, sizes, nullable):
        k, km = gf(cols, params)
        if can_null and km is not None:
            k = torch.where(km, k.to(torch.int64), mn + size - 1)
        keys.append(k)
    gid = agg.dense_group_ids(keys, mins, strides, domain)
    outs = []
    for kind, argf, acc in spec_entries:
        if kind == "count":
            outs.append(agg.grouped_partial(gid, mask, [("count", None, acc)], domain)[0])
            continue
        v, vm = argf(cols, params)
        if kind == "count_arg":
            ones = torch.ones(n, dtype=torch.int64)
            if vm is not None:
                ones = torch.where(vm, ones, 0)
            outs.append(agg.grouped_partial(gid, mask, [("sum", ones, np.int64)],
                                            domain)[0])
            continue
        if vm is not None:
            v = v.to(torch.int64 if np.dtype(acc).kind == "i" else torch.float64)
            if kind in ("sum", "sumsq"):
                v = torch.where(vm, v, 0)
            elif kind == "min":
                v = torch.where(vm, v, agg._max_sentinel(acc))
            else:
                v = torch.where(vm, v, agg._min_sentinel(acc))
        outs.append(agg.grouped_partial(gid, mask, [(kind, v, acc)], domain)[0])
    return outs


@pytest.mark.parametrize("acc", [np.int64, np.float64])
def test_agg_partials_with_null_keys_and_arguments(acc):
    """The generic path's _agg_partials over three chunks, keys and
    arguments with NULLs: the NULL key in its slot, NULL arguments neutral,
    count(arg) over the valid rows; equal to the old per-spec partials
    merged chunk by chunk."""
    rng = np.random.default_rng(17)
    size = 6  # five key values and the NULL slot
    dense = ([0], [1], [size], size, [True])

    def chunk():
        n = 3000
        key = torch.from_numpy(rng.integers(0, size - 1, n))
        key_ok = torch.from_numpy(rng.random(n) < 0.8)
        val = torch.from_numpy(_values(rng, n, acc))
        val_ok = torch.from_numpy(rng.random(n) < 0.6)
        mask = torch.from_numpy(rng.random(n) < 0.7)
        return [(key, key_ok), (val, val_ok)], mask

    group_fns = [lambda cols, _p: cols[0]]
    arg = lambda cols, _p: cols[1]  # noqa: E731
    spec_entries = [("sum", arg, acc), ("count_arg", arg, np.int64),
                    ("sumsq", arg, acc), ("min", arg, acc), ("max", arg, acc),
                    ("count", None, np.int64)]
    partials, want = None, None
    for _ in range(3):
        cols, mask = chunk()
        partials, ran = device_scan._agg_partials(cols, mask, (), spec_entries,
                                                  group_fns, dense, partials)
        assert ran == (0, 0)
        old = _old_chunk_partials(cols, mask, (), spec_entries, group_fns, dense)
        want = old if want is None else [
            agg.merge_partials(device_scan._merge_kind(k), a, b)
            for (k, _f, _a), a, b in zip(spec_entries, want, old)]
    assert len(partials) == len(want)
    for (kind, _f, _a), got, w in zip(spec_entries, partials, want):
        assert got.dtype == w.dtype and torch.equal(got, w), kind


SEG_ROWS = 4096
N = SEG_ROWS * 12
REVENUE = ("SELECT k, sum(p * (1 - d)) AS r FROM l WHERE s >= '1994-01-01' "
           "AND s < '1994-04-01' GROUP BY k ORDER BY r DESC, k LIMIT 10")


def _revenue_data():
    rng = np.random.default_rng(7)
    return {"k": rng.integers(1, 3000, N), "p": rng.integers(100, 10_000_000, N),
            "d": rng.integers(0, 11, N),
            "s": (np.datetime64("1992-01-02") + rng.integers(0, 2500, N)).astype(
                "datetime64[D]"),
            "p_ok": rng.random(N) >= 0.01}


def _revenue_db(platform):
    """Twelve compacted segments of a lineitem-shaped table (supplier key,
    price and discount as DECIMAL, ship date, 1% NULL prices) on
    `platform`, routed to the generic device path."""
    data = _revenue_data()
    cfg = adacom_tpu_torch.DBConfig()
    cfg.segment_rows = SEG_ROWS
    cfg.device_agg_min_rows = 0
    db = adacom_tpu_torch.Database(config=cfg, platform=platform)
    con = db.connect()
    con.query("CREATE TABLE l(k BIGINT, p DECIMAL(12,2), d DECIMAL(12,2), s DATE)")
    app = con.appender("l")
    # DECIMAL(12,2) columns take their scaled integers
    app.append_columns({c: data[c] for c in "kpds"}, validity={"p": data["p_ok"]})
    app.close()
    db.catalog.get_column_segment_catalog().compact_all_segments()
    return db, con


def _revenue_numpy():
    """The revenue query's ten rows from the generated data: per supplier
    with a row in the quarter, the sum over its valid prices as a
    scale-4 integer, or None where every price is NULL; NULLs sort first
    under DESC, as the engine orders them."""
    d = _revenue_data()
    keep = (d["s"] >= np.datetime64("1994-01-01")) & (d["s"] < np.datetime64("1994-04-01"))
    totals = {}
    for k, p, disc, ok in zip(d["k"][keep].tolist(), d["p"][keep].tolist(),
                              d["d"][keep].tolist(), d["p_ok"][keep].tolist()):
        if ok:
            totals[k] = (totals.get(k) or 0) + p * (100 - disc)
        else:
            totals.setdefault(k, None)
    return sorted(totals.items(), key=lambda kv: (kv[1] is not None,
                                                  -(kv[1] or 0), kv[0]))[:10]


def _scaled(rows):
    return [None if r[1] is None else round(float(r[1]) * 10_000) for r in rows]


def _partials_spans(profile):
    return [sp["counts"] for sp in profile["spans"] if sp["name"] == "agg.partials"]


def _chunks_of(profile):
    return sum(sp["counts"]["chunks"] for sp in profile["spans"]
               if sp["name"] == "scan.pools")


def test_revenue_group_by_on_cpu_counts_no_kernel(monkeypatch):
    """Three chunks of four segments; the answer equals the NumPy
    reference; every agg.partials span says the plain version ran."""
    monkeypatch.setattr(device_scan, "CHUNK_ROWS", 4 * SEG_ROWS)
    db, con = _revenue_db("cpu")
    try:
        con.query("PRAGMA enable_profiling")
        before = tools.launch_counts()
        rows = con.query(REVENUE).fetchall()
        assert tools.launches_since(before)["scatter"] == 0
        parts = _partials_spans(con.last_profile)
        assert len(parts) == _chunks_of(con.last_profile) == 3
        assert all(c == {"scatter_kernel": 0, "scatter_smem": 0} for c in parts)
        want = _revenue_numpy()
        assert [r[0] for r in rows] == [k for k, _r in want]
        assert _scaled(rows) == [r for _k, r in want]
    finally:
        db.close()


def test_group_by_with_null_keys_on_cpu_matches_numpy():
    """A nullable key and a nullable argument, every aggregate kind the
    generic path accumulates (count(*), count(v), sum, avg, min, max,
    stddev), against NumPy over the rows the filter keeps."""
    rng = np.random.default_rng(23)
    n = 20_000
    g = rng.integers(0, 40, n)
    g_ok = rng.random(n) >= 0.1
    v = rng.integers(-5000, 5000, n)
    v_ok = rng.random(n) >= 0.2
    f = rng.integers(0, 10, n)
    cfg = adacom_tpu_torch.DBConfig()
    cfg.segment_rows = 4096
    cfg.device_agg_min_rows = 0
    db = adacom_tpu_torch.Database(config=cfg, platform="cpu")
    try:
        con = db.connect()
        con.query("CREATE TABLE t(g INTEGER, v BIGINT, f INTEGER)")
        app = con.appender("t")
        app.append_columns({"g": g, "v": v, "f": f}, validity={"g": g_ok, "v": v_ok})
        app.close()
        db.catalog.get_column_segment_catalog().compact_all_segments()
        before = tools.launch_counts()
        rows = con.query("SELECT g, count(*), count(v), sum(v), min(v), max(v), "
                         "stddev_samp(v) FROM t WHERE f < 7 GROUP BY g "
                         "ORDER BY g NULLS LAST").fetchall()
        assert tools.launches_since(before)["device_scan"] > 0
    finally:
        db.close()
    keep = f < 7
    want = []
    for key in list(range(40)) + [None]:
        sel = keep & (~g_ok if key is None else (g_ok & (g == key)))
        if not sel.any():
            continue
        vals = v[sel & v_ok]
        want.append((key, int(sel.sum()), len(vals),
                     int(vals.sum()) if len(vals) else None,
                     int(vals.min()) if len(vals) else None,
                     int(vals.max()) if len(vals) else None,
                     float(np.std(vals, ddof=1)) if len(vals) > 1 else None))
    assert len(rows) == len(want)
    for got, w in zip(rows, want):
        assert tuple(got[:6]) == w[:6], (got, w)
        if w[6] is None:
            assert got[6] is None
        else:
            assert got[6] == pytest.approx(w[6], rel=1e-9)


def test_an_empty_scan_gives_no_group():
    """Zonemaps drop every segment: no chunk, so no accumulator is made
    and the GROUP BY has no row."""
    cfg = adacom_tpu_torch.DBConfig()
    cfg.segment_rows = 4096
    cfg.device_agg_min_rows = 0
    db = adacom_tpu_torch.Database(config=cfg, platform="cpu")
    try:
        con = db.connect()
        con.query("CREATE TABLE t(g INTEGER, v BIGINT)")
        app = con.appender("t")
        app.append_columns({"g": np.arange(10_000) % 50, "v": np.arange(10_000)})
        app.close()
        db.catalog.get_column_segment_catalog().compact_all_segments()
        con.query("PRAGMA enable_profiling")
        assert con.query("SELECT g, sum(v) FROM t WHERE v > 1000000 "
                         "GROUP BY g").fetchall() == []
        assert _partials_spans(con.last_profile) == []
    finally:
        db.close()


def _malformed():
    gid = torch.zeros(64, dtype=torch.int64)
    mask = torch.ones(64, dtype=torch.bool)
    v = torch.arange(64, dtype=torch.int64)
    acc = torch.zeros(5, dtype=torch.int64)
    return [
        ("specs for accumulators", [acc], gid, mask, [], "specs for"),
        ("gid dtype", [acc], gid.to(torch.int32), mask, [("count", None, np.int64)],
         "int64"),
        ("mask shape", [acc], gid, mask[:10], [("count", None, np.int64)], "mask"),
        ("mask dtype", [acc], gid, mask.to(torch.int64), [("count", None, np.int64)],
         "mask"),
        ("kind", [acc], gid, mask, [("median", v, np.int64)], "no kind"),
        ("float count", [acc.double()], gid, mask, [("count", None, np.int64)],
         "count accumulator"),
        ("int32 accumulator", [acc.int()], gid, mask, [("sum", v, np.int32)],
         "sum accumulator"),
        ("accumulator shape", [acc, torch.zeros(6, dtype=torch.int64)], gid, mask,
         [("count", None, np.int64), ("sum", v, np.int64)], "accumulator"),
        ("values shape", [acc], gid, mask, [("sum", v[:3], np.int64)], "values"),
        ("no values", [acc], gid, mask, [("max", None, np.int64)], "values"),
        ("cpu", [acc], gid, mask, [("sum", v, np.int64)], "no kernel for device cpu"),
    ]


@pytest.mark.parametrize("case", _malformed(), ids=lambda c: c[0])
def test_kernel_wrapper_refuses_before_launching(case):
    """The kernel's wrapper raises on what the kernel does not take (and,
    on the CPU, for want of a kernel), and never falls back."""
    _name, accs, gid, mask, specs, match = case
    before = agg.SCATTER_LAUNCHES
    with pytest.raises(ValueError, match=match):
        agg._accumulate_kernel(accs, gid, mask, specs)
    assert agg.SCATTER_LAUNCHES == before


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


def _card_inputs(dev, n, domain, keep, acc, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    gid = torch.randint(0, domain, (n,), generator=g, device=dev)
    mask = torch.randint(0, keep, (n,), generator=g, device=dev) == 0
    if np.dtype(acc).kind == "f":
        v = torch.randn(n, generator=g, device=dev, dtype=torch.float64) * 1e6
    else:
        v = torch.randint(-(1 << 20), 1 << 20, (n,), generator=g, device=dev)
    return gid, mask, v


def _check_card(dev, gid, mask, v, domain, acc, kinds, chunks=2):
    """Kernel against the plain version on the same CUDA tensors over
    `chunks` chunks into running accumulators; returns (kernel, shared)."""
    specs = [(k, None if k == "count" else v, acc) for k in kinds]
    got = agg.new_accumulators([(k, acc) for k in kinds], domain, dev)
    want = agg.new_accumulators([(k, acc) for k in kinds], domain, dev)
    before = agg.SCATTER_LAUNCHES
    for _ in range(chunks):
        ran = agg.grouped_accumulate(got, gid, mask, specs)
        agg.grouped_accumulate_reference(want, gid, mask, specs)
    torch.cuda.synchronize(dev)
    assert agg.SCATTER_LAUNCHES == before + chunks * (-(-len(kinds) // 32))
    assert ran[0] == 1
    for kind, a, b in zip(kinds, got, want):
        assert a.dtype == b.dtype, kind
        if a.dtype == torch.float64 and kind in ("sum", "sumsq"):
            x = v if kind == "sum" else v * v
            sel = torch.where(mask, x.abs(), 0.0)
            mag = torch.zeros(domain, dtype=torch.float64, device=dev).index_add_(
                0, gid, sel) * chunks
            cnt = torch.zeros(domain, dtype=torch.float64, device=dev).index_add_(
                0, gid, mask.double()) * chunks
            bound = 2 * torch.clamp(cnt - 1, min=0) * np.finfo(np.float64).eps * mag
            assert bool(((a - b).abs() <= bound).all()), kind
        else:
            assert torch.equal(a, b), kind
    return ran


def _smem_domain(n_specs):
    """The largest domain whose n_specs accumulators fit the kernel's
    shared memory."""
    return SMEM_BYTES // (8 * n_specs)


def _card_cases():
    out = []
    for acc in (np.int64, np.float64):
        a = "i64" if acc is np.int64 else "f64"
        for domain in (1, 7, 1000):
            out.append(pytest.param(1 << 20, domain, 3, acc, KINDS, 1,
                                    id=f"d{domain}-{a}"))
        d = _smem_domain(len(KINDS))
        for dom, shared in ((d, 1), (d + 1, 0)):
            out.append(pytest.param(1 << 20, dom, 2, acc, KINDS, shared,
                                    id=f"d{dom}-{'smem' if shared else 'global'}-{a}"))
        out.append(pytest.param(1 << 18, 100_000, 28, acc, KINDS, 0, id=f"d100000-{a}"))
        out.append(pytest.param(4099, 13, 1, acc, KINDS, 1, id=f"ragged-all-kept-{a}"))
    out.append(pytest.param(1 << 20, 50, 2, np.int64, ("count",) * 40, 1,
                            id="forty-counts-two-launches"))
    return out


@pytest.mark.card
@pytest.mark.parametrize("n, domain, keep, acc, kinds, shared", _card_cases())
def test_kernel_equals_plain_version(card, n, domain, keep, acc, kinds, shared):
    gid, mask, v = _card_inputs(card, n, domain, keep, acc, seed=n + domain + keep)
    ran = _check_card(card, gid, mask, v, domain, acc, kinds)
    assert ran == (1, shared)


@pytest.mark.card
def test_kernel_at_the_revenue_chunk_shape(card):
    """2^24 rows, 100,000 groups, 1 row in 28 kept: an int64 sum and two
    counts (the sum's count and the hidden one), the global regime."""
    gid, mask, v = _card_inputs(card, 1 << 24, 100_000, 28, np.int64, seed=28)
    v = v.abs() * 1000  # revenue-sized int64 values
    assert _check_card(card, gid, mask, v, 100_000, np.int64,
                       ("sum", "count", "count")) == (1, 0)


@pytest.mark.card
def test_kernel_edges_on_the_card(card):
    """A mask not 16-byte aligned (a slice), a constant value (stride 0),
    group ids at both ends, int64 extremes in min/max and wrapping sums,
    float NaN in min/max."""
    n, domain = 10_003, 5
    base = torch.zeros(n + 1, dtype=torch.bool, device=card)
    base[1::3] = True
    mask = base[1:]
    gid = torch.arange(n, device=card) % domain
    ext = torch.tensor([np.iinfo(np.int64).max, np.iinfo(np.int64).min, 0, -1, 1],
                       device=card).repeat(n // 5 + 1)[:n]
    specs = [("sum", ext, np.int64), ("min", ext, np.int64), ("max", ext, np.int64),
             ("sum", torch.full((1,), 3, device=card).expand(n), np.int64),
             ("count", None, np.int64)]
    got = agg.new_accumulators([(k, a) for k, _v, a in specs], domain, card)
    want = agg.new_accumulators([(k, a) for k, _v, a in specs], domain, card)
    agg.grouped_accumulate(got, gid, mask, specs)
    agg.grouped_accumulate_reference(want, gid, mask, specs)
    torch.cuda.synchronize(card)
    for (kind, _v, _a), a, b in zip(specs, got, want):
        assert torch.equal(a, b), kind
    f = torch.randn(n, dtype=torch.float64, device=card)
    f[7] = float("nan")
    fspecs = [("min", f, np.float64), ("max", f, np.float64)]
    got = agg.new_accumulators([(k, a) for k, _v, a in fspecs], domain, card)
    all_kept = torch.ones(n, dtype=torch.bool, device=card)
    agg.grouped_accumulate(got, gid, all_kept, fspecs)
    want = agg.new_accumulators([(k, a) for k, _v, a in fspecs], domain, "cpu")
    agg.grouped_accumulate_reference(want, gid.cpu(), all_kept.cpu(),
                                     [(k, v.cpu(), a) for k, v, a in fspecs])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())  # NaN == NaN here


@pytest.mark.card
def test_revenue_on_the_card_answers_as_the_host_aggregate(card, monkeypatch):
    """Three chunks: one launch each, every agg.partials span counting the
    kernel (global regime at 3,000 groups x 3 specs), the answer equal to
    the host aggregate's, a CPU database's and the NumPy reference's."""
    monkeypatch.setattr(device_scan, "CHUNK_ROWS", 4 * SEG_ROWS)
    db, con = _revenue_db("cuda")
    try:
        con.query("PRAGMA enable_profiling")
        before = tools.launch_counts()
        got = con.query(REVENUE).fetchall()
        chunks = _chunks_of(con.last_profile)
        assert chunks == 3
        assert tools.launches_since(before)["scatter"] == chunks
        parts = _partials_spans(con.last_profile)
        assert parts == [{"scatter_kernel": 1, "scatter_smem": 0}] * chunks
        con.query(f"SET device_agg_min_rows = {N * 10}")
        before = tools.launch_counts()
        host = con.query(REVENUE).fetchall()
        assert tools.launches_since(before)["scatter"] == 0  # the host aggregate
        assert got == host
    finally:
        db.close()
    cdb, ccon = _revenue_db("cpu")
    try:
        assert ccon.query(REVENUE).fetchall() == got
    finally:
        cdb.close()
    want = _revenue_numpy()
    assert [r[0] for r in got] == [k for k, _r in want]
    assert _scaled(got) == [r for _k, r in want]


@pytest.mark.card
def test_small_domain_group_by_takes_the_shared_memory_regime(card):
    """A 40-group GROUP BY with five specs on the card: every chunk in the
    shared-memory regime, answers equal to a CPU database's."""
    rng = np.random.default_rng(31)
    n = 12 * 4096
    data = {"g": rng.integers(0, 40, n), "v": rng.integers(-9999, 9999, n),
            "f": rng.integers(0, 10, n)}
    sql = ("SELECT g, count(*), sum(v), min(v), max(v) FROM t WHERE f < 3 "
           "GROUP BY g ORDER BY g")
    answers = []
    for platform in ("cuda", "cpu"):
        cfg = adacom_tpu_torch.DBConfig()
        cfg.segment_rows = 4096
        cfg.device_agg_min_rows = 0
        db = adacom_tpu_torch.Database(config=cfg, platform=platform)
        try:
            con = db.connect()
            con.query("CREATE TABLE t(g INTEGER, v BIGINT, f INTEGER)")
            app = con.appender("t")
            app.append_columns(data)
            app.close()
            db.catalog.get_column_segment_catalog().compact_all_segments()
            con.query("PRAGMA enable_profiling")
            answers.append(con.query(sql).fetchall())
            parts = _partials_spans(con.last_profile)
            kernel = 1 if platform == "cuda" else 0
            assert parts and all(c == {"scatter_kernel": kernel, "scatter_smem": kernel}
                                 for c in parts), parts
        finally:
            db.close()
    assert answers[0] == answers[1] and len(answers[0]) == 40
