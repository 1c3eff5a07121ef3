"""The port's ClickBench module against the JAX package's, on the CPU.

The generator draws the same data as the JAX package's except URLHash and
RefererHash, which come from a hash that is the same in every process
(the JAX package uses Python's per-process salted ``hash()``). All 43
queries run on the port (compacted) and on the JAX package over the same
data dict, and against sqlite; floats agree within rel_tol=1e-9,
abs_tol=1e-9 after rounding to 6 places (the module's own comparison),
everything else exactly."""

import hashlib
import io
import os
import sqlite3
import subprocess
import sys

import numpy as np
import pytest

import adacom_tpu
import adacom_tpu_torch
from adacom_tpu.bench import clickbench as jcb
from adacom_tpu_torch.bench import clickbench as cb


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


SCALE = 0.002  # 20,000 rows
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HASHED = ("urlhash", "refererhash")


@pytest.fixture(scope="module")
def data():
    return cb.generate(SCALE)


@pytest.fixture(scope="module")
def port(data):
    db = adacom_tpu_torch.Database(platform="cpu")
    con = db.connect()
    cb.load_into_engine(con, data)
    db.catalog.get_column_segment_catalog().compact_all_segments()
    yield con
    db.close()


@pytest.fixture(scope="module")
def reference(data):
    db = adacom_tpu.Database()
    con = db.connect()
    jcb.load_into_engine(con, data)
    db.catalog.get_column_segment_catalog().compact_all_segments()
    yield con
    db.close()


@pytest.fixture(scope="module")
def lite(data):
    lite = sqlite3.connect(":memory:")
    cb.load_into_sqlite(lite, data)
    yield lite
    lite.close()


def test_generate_matches_reference_but_the_hashes(data):
    ref = jcb.generate(SCALE)
    assert list(data) == list(ref) == ["hits"]
    assert list(data["hits"]) == list(ref["hits"])
    for col, (ty, arr) in data["hits"].items():
        rty, rarr = ref["hits"][col]
        assert ty == rty and arr.dtype == rarr.dtype and len(arr) == len(rarr)
        if col not in HASHED:
            assert np.array_equal(arr, rarr), col
    # the probe hashes sit in the same rows of both
    for col, probe in (("urlhash", cb.PROBE_URLHASH),
                       ("refererhash", cb.PROBE_REFERERHASH)):
        got = data["hits"][col][1] == probe
        assert got.any() and np.array_equal(got, ref["hits"][col][1] == probe)
    # every other row is the stable hash of its string
    url = data["hits"]["url"][1]
    h = data["hits"]["urlhash"][1]
    free = h != cb.PROBE_URLHASH
    assert all(cb.stable_hash(u) == v for u, v in zip(url[free], h[free]))
    assert (h >= 0).all() and (data["hits"]["refererhash"][1] >= 0).all()


def _hash_digest(seed: str) -> str:
    code = ("import hashlib\n"
            "from adacom_tpu_torch.bench import clickbench as cb\n"
            "h = cb.generate(0.0005)['hits']\n"
            "print(hashlib.sha256(h['urlhash'][1].tobytes()"
            " + h['refererhash'][1].tobytes()).hexdigest())\n")
    env = dict(os.environ, PYTHONHASHSEED=seed)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip()


def test_hashes_equal_across_processes():
    h = cb.generate(0.0005)["hits"]
    here = hashlib.sha256(h["urlhash"][1].tobytes()
                          + h["refererhash"][1].tobytes()).hexdigest()
    assert _hash_digest("1") == _hash_digest("2") == here


@pytest.mark.parametrize("qid", sorted(cb.QUERIES))
def test_query_matches_reference_and_sqlite(port, reference, lite, qid):
    assert cb.QUERIES[qid] == jcb.QUERIES[qid]
    assert cb.ORACLE_QUERIES[qid] == jcb.ORACLE_QUERIES[qid]
    got = port.query(cb.QUERIES[qid]).fetchall()
    assert cb.answers_equal(qid, got,
                            reference.query(jcb.QUERIES[qid]).fetchall())
    assert cb.answers_equal(qid, got,
                            lite.execute(cb.ORACLE_QUERIES[qid]).fetchall())
    assert cb.verify_against_oracle(port, lite, qid)


def test_answers_equal_detects_a_difference():
    rows = [(1, "a", 0.5)]
    assert cb.answers_equal(1, rows, [(1, "a", 0.5 + 1e-12)])
    assert not cb.answers_equal(1, rows, [(1, "a", 0.5001)])
    assert not cb.answers_equal(1, rows, [(2, "a", 0.5)])
    assert not cb.answers_equal(1, rows, rows + rows)
    # unordered queries compare as sets of rows, ordered ones do not
    assert cb.answers_equal(1, [(1,), (2,)], [(2,), (1,)])
    assert not cb.answers_equal(8, [(1, 5), (2, 3)], [(2, 3), (1, 5)])


def test_sqlite_answers_and_run_with_oracle(tmp_path):
    """tools/clickbench_run.run with an oracle from another process's
    answers (the JSON form) writes the runner's TSV schema."""
    from adacom_tpu_torch.tools import clickbench_run

    scale = 0.0005
    want = cb.sqlite_answers(scale)
    assert sorted(int(q) for q in want["answers"]) == sorted(cb.QUERIES)
    out = tmp_path / "cb.tsv"
    res = clickbench_run.run(scale, nruns=1, platform="cpu",
                             oracle=lambda q: want["answers"][q], out=str(out),
                             log=io.StringIO())
    assert res["rows"] == 5000 and sorted(res["queries"]) == sorted(cb.QUERIES)
    lines = out.read_text().splitlines()
    assert lines[0].startswith("# ClickBench 43 queries, 5000 rows")
    assert len(lines) == 1 + 43
    name, run, timing, before, after = lines[1].split("\t")
    assert name == "ClickBench_Q01" and run == "1" and float(timing) > 0
    assert int(before) == res["size"] > 0 and int(after) > 0
    with pytest.raises(AssertionError, match="Q1:"):
        clickbench_run.run(scale, nruns=0, platform="cpu",
                           oracle=lambda q: [(-1,)], log=io.StringIO())
