"""Build and load the port's shared libraries on first use.

Two libraries come from sources in the checkout:

- ``csrc/*.cu``: the hand-written CUDA kernels, compiled by ``nvcc`` for
  ``sm_90a`` into a library with a plain C interface (loaded with ctypes);
- ``native/adacom_native.cpp``: the host runtime shared with the JAX
  package, compiled by the C++ compiler for the machine it runs on.

Builds land in ``_build/`` inside the package (ignored by git), named by a
hash of the sources and flags, so an edit rebuilds and concurrent test
workers build once under a file lock. Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import platform
import shutil
import subprocess
from typing import List

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
NATIVE_SRC = os.path.join(os.path.dirname(PKG_DIR), "native", "adacom_native.cpp")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-shared"]


class BuildError(RuntimeError):
    pass


def build_shared(name: str, sources: List[str], cmd: List[str]) -> str:
    """Compile `sources` with `cmd` (compiler + flags) into a shared library
    under BUILD_DIR and return its path; reuses an existing build of the
    same sources and flags. The compiler's output goes to ``<lib>.log``."""
    h = hashlib.sha256(" ".join(cmd).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(out):
            tmp = f"{out}.{os.getpid()}.tmp"
            proc = subprocess.run(cmd + ["-o", tmp] + sources,
                                  capture_output=True, text=True)
            with open(out + ".log", "w") as log:
                log.write(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise BuildError(f"building {name} failed:\n{proc.stderr}")
            os.replace(tmp, out)
    return out


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cands.append(os.path.join(home, "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


@functools.lru_cache(maxsize=None)
def kernels() -> ctypes.CDLL:
    """The CUDA kernel library (built from csrc/ on first call)."""
    srcs = sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith(".cu"))
    path = build_shared("adacom_kernels", srcs, [find_nvcc()] + NVCC_FLAGS)
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.adacom_table_scan.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp]
    lib.adacom_table_scan.restype = ci
    lib.adacom_table_scan_threads.argtypes = []
    lib.adacom_table_scan_threads.restype = ci
    return lib


def _cpu_model() -> str:
    """The host CPU's model string: -march=native code runs only on it."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def native_library() -> str:
    """Path of the host runtime library (built from native/ on first call,
    once per CPU model)."""
    cxx = os.environ.get("CXX", "g++")
    # the model string rides in a -D flag, so it enters the build hash
    tag = "-DADACOM_CPU=" + hashlib.sha256(_cpu_model().encode()).hexdigest()[:12]
    return build_shared("adacom_native", [NATIVE_SRC], [cxx] + CXX_FLAGS + [tag])
