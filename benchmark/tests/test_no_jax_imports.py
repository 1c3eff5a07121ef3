"""Nothing the harness loads imports JAX or the JAX package (top-level
names compared whole); the references import nothing of the program; and
nothing under benchmark/ reads the JAX package's records or files."""

import ast
import os
import subprocess
import sys

from benchmark import registry

FORBIDDEN = {"jax", "jaxlib", "flax", "adacom_tpu"}


def _sources():
    for dirpath, _, files in os.walk(registry.HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax():
    for path in _sources():
        if os.sep + "tests" + os.sep in path:
            continue
        assert not set(_imports(path)) & FORBIDDEN, path


def test_references_import_nothing_of_the_program():
    ref_dir = os.path.join(registry.HERE, "reference")
    for f in os.listdir(ref_dir):
        if f.endswith(".py"):
            names = set(_imports(os.path.join(ref_dir, f)))
            assert not names & (FORBIDDEN | {"adacom_tpu_torch", "benchmark"}), f


def test_nothing_reads_the_jax_packages_files():
    for path in _sources():
        if path == os.path.abspath(__file__):
            continue
        text = open(path).read()
        assert "BENCH_r" not in text and "adacom_tpu/" not in text, path


def test_a_run_loads_no_jax():
    code = ("import sys, time; sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r});"
            "from test_mix_rehearsal import run; from benchmark import harness, registry;"
            "r = run(registry.load_spec(), 'lineitem_sf10.revenue', seconds=0.5);"
            "print(r['correct'], harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code.format(
        root=registry.ROOT, tests=os.path.dirname(os.path.abspath(__file__)))],
        capture_output=True, text=True, timeout=300, cwd=registry.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[-2] == "True []"


def test_the_command_refuses_without_a_card(tmp_path):
    """Without a card (or without the program), no result is printed."""
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, os.path.join(registry.HERE, "run.py"),
                          "--workload", "lineitem_sf10.revenue", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=120,
                         cwd=registry.ROOT)
    assert out.returncode != 0 and out.stdout == ""
