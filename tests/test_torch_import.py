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
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'adacom_tpu' or m.startswith('adacom_tpu.'))\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "[]"
