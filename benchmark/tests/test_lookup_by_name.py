"""Everything a name in BENCHMARK.json needs is found by name, and the
file keeps to the shape its format requires."""

import json
import os
import re
import sys

from benchmark import registry, traffic

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_name_finds_its_files(spec):
    for cfg in spec["configs"]:
        assert os.path.exists(os.path.join(registry.ROOT, cfg["file"]))
        assert hasattr(registry.load_module("configs", cfg["name"]), "generate")
        assert hasattr(registry.load_module("reference", cfg["name"]), "Reference")
        assert cfg["file"].startswith("benchmark/")
    for w in spec["workloads"]:
        desc = registry.config_desc(spec, w["config"])
        mix = traffic.Mix(registry.load_json("traffic", w["traffic"]), desc)
        ref = registry.load_module("reference", w["config"]).Reference
        for tpl in mix.templates.values():
            assert hasattr(ref, tpl.answer), tpl.answer
            for col in tpl.reads:
                table, c = col.split(".")
                assert c in desc["tables"][table]
        limits = registry.load_json("limits", w["name"])
        assert limits["wrong_answers"] == 0 and limits["max_rel_gap"] > 0
    for m in spec["per_layer"]:
        assert callable(registry.load_module("metrics", m["name"]).read)


def test_benchmark_json_shape(spec):
    keys = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert set(spec) == keys
    names = [x["name"] for sec in ("configs", "workloads", "end_to_end", "per_layer")
             for x in spec[sec]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    cells = {w["name"] for w in spec["workloads"]}
    used = {w["config"] for w in spec["workloads"]}
    assert used == {c["name"] for c in spec["configs"]}
    layers = {m["layer"] for m in spec["per_layer"]}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        for c in m.get("workloads", cells):
            assert c in cells
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or c in moved["workloads"]
    for c in cells:
        assert any("workloads" not in m or c in m["workloads"] for m in spec["per_layer"])
    assert all(w["chips"] == 1 for w in spec["workloads"])
    assert len(json.dumps(spec)) < 64 * 1024 and layers


def test_metric_names_with_dots_load(monkeypatch, tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "p95_ms.serve.py").write_text("def read(ctx):\n    return 1.0\n")
    monkeypatch.setattr(registry, "HERE", str(tmp_path))
    try:
        assert registry.load_module("metrics", "p95_ms.serve").read({}) == 1.0
    finally:
        sys.modules.pop("benchmark.metrics.p95_ms.serve", None)
