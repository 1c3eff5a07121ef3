"""The port's TPC-H and measurement tools on the CPU, held against sqlite,
numpy and the JAX package's tools on the same data: all 22 TPC-H answers
of `verify_sf1` at SF 0.01, `tpch_sf1`'s TSV with the JAX package's
compacted footprint, `record_suites`' names and footprints, the footprint
fields of `string_bench.one_case`, the answers of `grouped_agg_bench`,
the all-packed bytes of `adaptive_overtime`, and `q18_stream`'s streamed
counter. Every comparison is exact.

Each test runs the tool's command line in an empty directory and checks
that it wrote only the file it was given. The reference tools
(`tools/*.py`) run in that directory too, so the records they write under
fixed names there leave the repository's untouched."""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest

import adacom_tpu
from adacom_tpu_torch.bench import tpch
from adacom_tpu_torch.tools import (adaptive_overtime, grouped_agg_bench,
                                    q18_stream, record_suites, string_bench,
                                    tpch_sf1, verify_sf1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reference_tool(name):
    """tools/<name>.py of the JAX package, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"_reference_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def _cold_pallas_runner_caches():
    """tests/test_pallas.py counts its Pallas runner caches' misses: leave
    them cold for the modules that run after this one in the process."""
    yield
    from adacom_tpu.ops import pallas_scan

    for f in vars(pallas_scan).values():
        if hasattr(f, "cache_clear") and \
                getattr(f, "__module__", None) == pallas_scan.__name__:
            f.cache_clear()


def test_verify_sf1_all_22_equal_sqlite(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert verify_sf1.main(["0.01", "--platform", "cpu", "--out",
                            "v.json"]) == 0
    assert os.listdir(tmp_path) == ["v.json"]
    with open(tmp_path / "v.json") as f:
        rec = json.load(f)
    assert (rec["passed"], rec["total"], rec["sf"]) == (22, 22, 0.01)
    assert all(q["ok"] and "got_head" not in q
               for q in rec["queries"].values())
    assert sorted(rec["queries"]) == [f"Q{i:02d}" for i in range(1, 23)]


def test_tpch_sf1_tsv_and_footprint(tmp_path, monkeypatch):
    """22 x nruns rows in the runner's schema; sizeInBytes is the JAX
    package's compacted footprint of the same data (the words are byte
    identical)."""
    monkeypatch.chdir(tmp_path)
    assert tpch_sf1.main(["2", "--sf", "0.01", "--platform", "cpu",
                          "--tsv", "t.tsv", "--md", "t.md"]) == 0
    assert sorted(os.listdir(tmp_path)) == ["t.md", "t.tsv"]
    rows = [ln.split("\t") for ln in
            (tmp_path / "t.tsv").read_text().splitlines()]
    assert len(rows) == 22 * 2
    assert [(r[0], r[1]) for r in rows] == [
        (f"TPCH_Q{q:02d}", str(run)) for q in range(1, 23)
        for run in (1, 2)]
    db = adacom_tpu.Database()
    con = db.connect()
    tpch.load_into_engine(con, tpch.generate(sf=0.01))
    cat = db.catalog.get_column_segment_catalog()
    cat.compact_all_segments()
    want = cat.get_total_data_size()
    db.close()
    assert {int(r[3]) for r in rows} == {want}
    assert {int(r[4]) for r in rows} == {want}
    md = (tmp_path / "t.md").read_text()
    assert "not a TPU or H100 figure" in md and "| Q22 |" in md


def test_record_suites_equals_reference(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = ["--scale", "0.0002", "--nruns", "1", "--pattern",
            "SuccinctZipfDistribution"]
    monkeypatch.setattr(sys, "argv", ["record_suites.py", *args,
                                      "--out", "ref.tsv"])
    reference_tool("record_suites").main()
    assert record_suites.main(args + ["--platform", "cpu", "--out",
                                      "port.tsv"]) == 0
    assert sorted(os.listdir(tmp_path)) == ["port.tsv", "ref.tsv"]

    def rows(name):
        return [ln.split("\t") for ln in
                (tmp_path / name).read_text().splitlines()[1:]]

    got, want = rows("port.tsv"), rows("ref.tsv")
    assert [r[0] for r in got] == [r[0] for r in want] == [
        "SuccinctZipfDistribution", "NonSuccinctZipfDistribution"]
    assert [(r[1], r[3], r[4]) for r in got] == \
        [(r[1], r[3], r[4]) for r in want]


@pytest.mark.parametrize("card", [1000, 20_000])
def test_string_bench_footprints_equal_reference(card):
    keys = ("rows", "distinct", "raw_bytes", "dict_bytes",
            "dict_fsst_bytes", "fsst_adopted", "vs_raw_dict",
            "vs_raw_dict_fsst")
    got = string_bench.one_case(20_000, card, "cpu")
    want = reference_tool("string_bench").one_case(20_000, card)
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["fsst_adopted"]


def test_grouped_agg_bench_answers(tmp_path, monkeypatch):
    """Both sides' answers equal numpy's and the JAX package's on the same
    data; each side is named by its route."""
    monkeypatch.chdir(tmp_path)
    rows = 200_000
    assert grouped_agg_bench.main([str(rows), "--platform", "cpu",
                                   "--out", "g.json"]) == 0
    assert os.listdir(tmp_path) == ["g.json"]
    with open(tmp_path / "g.json") as f:
        rec = json.load(f)
    rng = np.random.default_rng(13)
    g = rng.integers(0, 6, rows).astype(np.int32)
    v = rng.integers(0, 100_000, rows).astype(np.int32)
    want = [[k, int(v[g == k].astype(np.int64).sum()), int((g == k).sum())]
            for k in range(6)]
    assert rec["answer"] == want
    db = adacom_tpu.Database()
    db.config.pallas_scan_enabled = False
    con = db.connect()
    con.query("CREATE TABLE t(g INTEGER, v INTEGER)")
    app = con.appender("t")
    app.append_columns({"g": g, "v": v})
    app.close()
    db.catalog.get_column_segment_catalog().compact_all_segments()
    ref = [list(map(int, r)) for r in con.query(grouped_agg_bench.QUERY)
           .fetchall()]
    db.close()
    assert ref == want
    # on the CPU the fused tier runs its plain version and launches nothing
    assert rec["engine_s"]["fused_on"]["route"] == "b2_plain_version"
    assert rec["engine_s"]["fused_off"]["route"] in (
        "generic_device_path", "host_aggregate")


def test_adaptive_overtime_against_reference(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    n = 200_000
    monkeypatch.setattr(sys, "argv", ["adaptive_overtime.py", str(n), "1"])
    reference_tool("adaptive_overtime").main()
    last = (tmp_path / "ADAPTIVE_OVERTIME.tsv").read_text().splitlines()[-1]
    ref = dict(kv.split("=") for kv in last[2:].split())
    assert adaptive_overtime.main([str(n), "3", "--period", "0.5",
                                   "--platform", "cpu", "--out",
                                   "port.tsv"]) == 0
    assert sorted(os.listdir(tmp_path)) == ["ADAPTIVE_OVERTIME.tsv",
                                            "port.tsv"]
    lines = (tmp_path / "port.tsv").read_text().splitlines()
    assert lines[0] == adaptive_overtime.COLUMNS
    got = dict(kv.split("=") for kv in lines[-1][2:].split())
    assert got == ref  # all-plain, all-packed and rows
    assert int(lines[-2].split("\t")[5]) >= 1  # policy rounds
    assert all(len(ln.split("\t")) == 6 for ln in lines[1:-1])


def test_q18_stream_counter(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    res = q18_stream.run(0.01, "cpu")
    assert os.listdir(tmp_path) == []
    assert res["on"]["streamed"] > 0 and res["off"]["streamed"] == 0
    assert res["on"]["peak_extra_device_bytes"] is None
    for mode in ("on", "off"):
        assert len(res[mode]["18"]) == len(res[mode]["21"]) == 5
    assert any("streamed_join_agg hits" in ln for ln in res["lines"])
