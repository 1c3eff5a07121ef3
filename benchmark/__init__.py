"""The benchmark of adacom_tpu_torch: one cell of BENCHMARK.json per run.

Run from the root of a checkout, on a machine with an NVIDIA card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: ``configs/<config>.json`` (the
deployment: source, sizes, schema, settings) with ``configs/<config>.py``
(its generator from the seed), ``traffic/<mix>.json`` (clients, query
templates, parameter draws), ``reference/<config>.py`` (the plain NumPy
answers) and ``metrics/<metric>.py`` (one reader per per-layer metric).
"""
