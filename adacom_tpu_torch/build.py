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
              "-Xcompiler", "-fPIC", "-Xptxas=-v"]
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall"]


class BuildError(RuntimeError):
    pass


def _compile_link(cmd: List[str], sources: List[str], out: str) -> str:
    """Compile each source to an object with its own compiler process, all
    started together, then link them into the shared library `out`.
    Returns the compilers' output; raises BuildError on a failure."""
    objs = [f"{out}.{i}.o" for i in range(len(sources))]
    procs = [subprocess.Popen(cmd + ["-c", "-o", o, src],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for o, src in zip(objs, sources)]
    logs = [p.communicate()[0] for p in procs]
    try:
        for src, p, log in zip(sources, procs, logs):
            if p.returncode != 0:
                raise BuildError(f"compiling {src} failed:\n{log}")
        link = subprocess.run(cmd + ["-shared", "-o", out] + objs,
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise BuildError(f"linking {out} failed:\n{link.stderr}")
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    return "".join(logs) + link.stdout + link.stderr


def build_shared(name: str, sources: List[str], cmd: List[str]) -> str:
    """Compile `sources` with `cmd` (compiler + flags, without -shared) into
    a shared library under BUILD_DIR and return its path; reuses an
    existing build of the same sources and flags. Each source compiles in
    its own process, in parallel. The compilers' output goes to
    ``<lib>.log``."""
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
            try:
                text = _compile_link(cmd, sources, tmp)
            except BuildError as e:
                with open(out + ".log", "w") as log:
                    log.write(str(e))
                raise
            with open(out + ".log", "w") as log:
                log.write(text)
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
    lib.adacom_multi_grouped_scan.argtypes = [vp] * 6 + [ci] * 5 + [vp, vp] \
        + [ci] * 5 + [vp]
    lib.adacom_multi_grouped_scan.restype = ci
    lib.adacom_grouped_scan_threads.argtypes = []
    lib.adacom_grouped_scan_threads.restype = ci
    lib.adacom_grouped_scan_blocks_per_sm.argtypes = [ci] * 4
    lib.adacom_grouped_scan_blocks_per_sm.restype = ci
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
