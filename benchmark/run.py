"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits with a code other than 0, printing no result, when the machine has
fewer CUDA cards than the cell asks for or the checkout lacks the program.
"""

import time

PROCESS_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Build and kernel caches at fixed paths inside the checkout, so that only
# the first run of a cell in a checkout builds (the port's nvcc and host
# library builds already land in adacom_tpu_torch/_build/ there).
_CACHE = os.path.join(ROOT, ".bench_cache")
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "nv_compute")):
    os.environ[_var] = os.path.join(_CACHE, _sub)
# a library that would load JAX by itself is kept from doing so
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from benchmark import harness

    sys.exit(harness.main(sys.argv[1:], PROCESS_START))
