"""Finds what a name in BENCHMARK.json needs, by name, in files of its own.

A later change adds a configuration, a traffic mix or a per-layer metric by
adding files under these folders and entries in BENCHMARK.json; nothing
here names one."""

from __future__ import annotations

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_spec(path: str | None = None) -> dict:
    """BENCHMARK.json at the root of the checkout."""
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(folder: str, name: str) -> dict:
    with open(os.path.join(HERE, folder, f"{name}.json")) as f:
        return json.load(f)


def load_module(folder: str, name: str):
    """benchmark/<folder>/<name>.py, imported by its path (a metric's name
    may hold dots)."""
    path = os.path.join(HERE, folder, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    modname = f"benchmark.{folder}.{name}"
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(spec: dict, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def config_desc(spec: dict, name: str) -> dict:
    """The configuration as it is run: the JSON file the entry names."""
    with open(os.path.join(ROOT, config_entry(spec, name)["file"])) as f:
        return json.load(f)


def metrics_of(spec: dict, section: str, cell_name: str) -> list:
    """The metrics of `section` ("end_to_end" or "per_layer") that the cell
    reports: those without a workloads key, and those that list it."""
    return [m for m in spec[section]
            if "workloads" not in m or cell_name in m["workloads"]]
