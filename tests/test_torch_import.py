"""The port imports neither JAX nor the JAX package."""

import subprocess
import sys
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_import_loads_no_jax():
    code = (
        "import sys\n"
        "import adacom_tpu_torch\n"
        "import adacom_tpu_torch.main.database, adacom_tpu_torch.main.connection\n"
        "import adacom_tpu_torch.exec.executor, adacom_tpu_torch.ops.fused_scan\n"
        "import adacom_tpu_torch.native, adacom_tpu_torch.storage.segment\n"
        "import adacom_tpu_torch.exec.join, adacom_tpu_torch.exec.window\n"
        "import adacom_tpu_torch.exec.spill, adacom_tpu_torch.bench.tpch\n"
        "import adacom_tpu_torch.bench.runner, adacom_tpu_torch.bench.headline\n"
        "import adacom_tpu_torch.bench.clickbench, adacom_tpu_torch.bench.zipf\n"
        "import adacom_tpu_torch.bench.succinct_benchmarks\n"
        "import adacom_tpu_torch.tools.roofline\n"
        "import adacom_tpu_torch.tools.clickbench_run\n"
        "import adacom_tpu_torch.storage.wal, adacom_tpu_torch.storage.checkpoint\n"
        "import adacom_tpu_torch.dbapi, adacom_tpu_torch.shell\n"
        "import adacom_tpu_torch.main.relation, adacom_tpu_torch.main.verification\n"
        "import adacom_tpu_torch.sql.serialize, adacom_tpu_torch.io.csv_io\n"
        "import adacom_tpu_torch.io.json_io, adacom_tpu_torch.io.parquet_io\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'adacom_tpu' or m.startswith('adacom_tpu.'))\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "[]"


def test_parallel_and_graft_entry_load_no_jax():
    """The multi-device layer and the entry points load neither JAX nor
    the JAX package, also when the dryrun runs (on the CPU here)."""
    code = (
        "import sys\n"
        "import adacom_tpu_torch.parallel.ops, adacom_tpu_torch.parallel.mesh\n"
        "import adacom_tpu_torch.parallel.collectives\n"
        "from adacom_tpu_torch import graft_entry\n"
        "graft_entry.dryrun_multichip(2, 'cpu')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'adacom_tpu' or m.startswith('adacom_tpu.'))\n"
        "print(bad)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "2 virtual shards on cpu" in proc.stdout
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_shell_module_help_loads_no_jax():
    """`python3 -m adacom_tpu_torch --help` prints the shell's usage; the
    run loads neither JAX nor the JAX package."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['adacom_tpu_torch', '--help']\n"
        "try:\n"
        "    runpy.run_module('adacom_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'adacom_tpu' or m.startswith('adacom_tpu.'))\n"
        "print(bad)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "python3 -m adacom_tpu_torch" in proc.stdout
    assert ".tables" in proc.stdout
    assert proc.stdout.strip().splitlines()[-1] == "[]"
    proc = subprocess.run([sys.executable, "-m", "adacom_tpu_torch", "--help"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--platform cuda|cpu" in proc.stdout


TOOLS = ("fuzz_differential", "fuzz_dml", "verify_sf1", "tpch_sf1",
         "record_suites", "grouped_agg_bench", "string_bench",
         "adaptive_overtime", "q18_stream")


def test_tools_and_warmup_load_no_jax():
    """The device warm-up and every tool load neither JAX nor the JAX
    package, also when a fuzzer and the warm-up run (on the CPU here)."""
    code = (
        "import sys\n"
        "import adacom_tpu_torch.utils.warmup as w\n"
        + "".join(f"import adacom_tpu_torch.tools.{t}\n" for t in TOOLS) +
        "from adacom_tpu_torch.tools import fuzz_dml\n"
        "assert w.ensure_transfer_warm('cpu') is None\n"
        "assert fuzz_dml.run(20, 0, platform='cpu')['mismatch'] is None\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'adacom_tpu' or m.startswith('adacom_tpu.'))\n"
        "print(bad)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
