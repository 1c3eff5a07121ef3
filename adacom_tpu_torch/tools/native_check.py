"""Hold every function of the native host library against its NumPy fallback
on the same inputs.

`adacom_tpu_torch/native.py` compiles `native/adacom_native.cpp` with
`-march=native` for the machine it runs on, so each machine runs its own
build. `compare(n, seed)` draws inputs of about n elements from a seed,
calls each function once through the library and once with the library
switched off (`fallback()`: the function's NumPy path, or for the
functions whose callers fall back themselves, the NumPy expression those
callers use), and lists every difference: pack/unpack at six widths,
gather, the equality filters on plain and packed words, groupby, the
grouped sums (int64 and float64), the radix argsort, the hash join, the
range filters, the row gather at 1, 4 and 8 bytes and an FSST round trip.
The Zipf sampler is left out: its two paths draw from different
generators by design (tests/test_torch_bench.py holds each path against
the JAX package's).

    python3 -m adacom_tpu_torch.tools.native_check [N] [--seed S]

Prints one line; exits 1 on a difference, 2 when the library did not
build."""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

import numpy as np

from adacom_tpu_torch import native

PACK_WIDTHS = (1, 7, 16, 17, 31, 32)
FSST_STRINGS = 20_000


@contextlib.contextmanager
def fallback():
    """Inside the block every function of `native` takes its NumPy path."""
    real = native._load
    native._load = lambda: None
    try:
        yield
    finally:
        native._load = real


def _np_range(vals, lo, hi):
    return np.nonzero((vals >= lo) & (vals <= hi))[0]


def _np_join(build, probe):
    """All (probe_idx, build_idx) pairs with equal keys, by a sort-probe
    join over the build side."""
    order = np.argsort(build, kind="stable")
    sb = build[order]
    lo = np.searchsorted(sb, probe, "left")
    hi = np.searchsorted(sb, probe, "right")
    cnt = hi - lo
    li = np.repeat(np.arange(len(probe)), cnt)
    start = np.repeat(lo - np.concatenate([[0], np.cumsum(cnt)[:-1]]), cnt)
    return li, order[start + np.arange(len(li))]


def _pairs(li, ri):
    o = np.lexsort((ri, li))
    return np.stack([li[o], ri[o]])


def _fsst(strings):
    """Train, encode and decode every string with the library: the strings
    that do not come back (FSST has no NumPy path; the dictionary keeps its
    plain strings without the library)."""
    enc = [s.encode() for s in strings]
    offs = np.zeros(len(enc) + 1, np.int64)
    np.cumsum([len(e) for e in enc], out=offs[1:])
    arr = np.frombuffer(b"".join(enc), np.uint8)
    symtab, symlens, n = native.fsst_train(arr)
    blob, eoffs = native.fsst_encode(symtab, symlens, n, arr, offs)
    return [i for i, e in enumerate(enc) if native.fsst_decode(
        symtab, symlens, n, blob[eoffs[i]:eoffs[i + 1]]) != e]


def _cases(n: int, rng):
    """(name, call) for inputs of about n elements: `compare` makes each
    call once through the library and once inside `fallback()`."""
    cases = []
    for width in PACK_WIDTHS:
        codes = (rng.integers(0, 1 << 32, n, dtype=np.uint64)
                 & ((1 << width) - 1)).astype(np.uint32)
        words = native.pack_u32(codes, width)
        cases.append((f"pack_u32 w{width}",
                      lambda c=codes, w=width: native.pack_u32(c, w)))
        cases.append((f"unpack_u32 w{width}",
                      lambda ws=words, w=width: native.unpack_u32(ws, n, w)))
    width = 19
    codes = rng.integers(0, 1 << width, n, dtype=np.uint32)
    words = native.pack_u32(codes, width)
    idx = rng.integers(0, n, n // 4)
    lanes = max(1, (n + 31) // 32)
    cases.append(("gather_u32", lambda: native.gather_u32(words, lanes, width,
                                                          idx)))
    vals = rng.integers(0, 100, n).astype(np.uint32)
    cases.append(("filter_eq_u32", lambda: native.filter_eq_u32(vals, 42)))
    base = 1_000_000
    for v in (int(codes[n // 3]) + base, 5, base + (1 << width)):
        cases.append((f"packed_filter_eq_u32 {v}",
                      lambda v=v: native.packed_filter_eq_u32(
                          words, n, width, base, v)))
    keys = rng.integers(-5000, 5000, n).astype(np.int64)
    cases.append(("groupby_i64", lambda: native.groupby_i64(keys)))
    gid = rng.integers(0, 1000, n).astype(np.int64)
    ivals = rng.integers(-2 ** 40, 2 ** 40, n)
    # quarters whose partial sums stay exact in float64, in any order
    fvals = rng.integers(-4000, 4000, n) / 4.0
    cases.append(("group_sum i64", lambda: native.group_sum(gid, ivals, 1000)))
    cases.append(("group_sum f64", lambda: native.group_sum(gid, fvals, 1000)))
    ukeys = rng.integers(0, 2 ** 63, n).astype(np.uint64)
    dup = (np.arange(n) % 17).astype(np.uint64)
    cases.append(("argsort_u64", lambda: native.argsort_u64(ukeys)))
    cases.append(("argsort_u64 ties", lambda: native.argsort_u64(dup)))
    return cases


def _direct_cases(n: int, rng):
    """(name, library call, NumPy expression) for the functions whose
    callers fall back themselves (the function returns None)."""
    cases = []
    build = rng.integers(0, n // 2, n // 4).astype(np.int64)
    probe = rng.integers(0, n // 2, n // 2).astype(np.int64)
    cases.append(("hash_join_i64",
                  lambda: _pairs(*native.hash_join_i64(build, probe)),
                  lambda: _pairs(*_np_join(build, probe))))
    v64 = rng.integers(-1 << 40, 1 << 40, n).astype(np.int64)
    v32 = rng.integers(-1 << 30, 1 << 30, n).astype(np.int32)
    cases.append(("filter_range_i64",
                  lambda: native.filter_range_i64(v64, -1 << 38, 1 << 39),
                  lambda: _np_range(v64, -1 << 38, 1 << 39)))
    cases.append(("filter_range_i32",
                  lambda: native.filter_range_i32(v32, -1 << 28, 1 << 29),
                  lambda: _np_range(v32, -1 << 28, 1 << 29)))
    idx = rng.integers(0, n, n).astype(np.int64)
    for dt in (np.int64, np.float32, np.uint8):
        src = rng.integers(0, 250, n).astype(dt)
        cases.append((f"gather_rows {np.dtype(dt).name}",
                      lambda s=src: native.gather_rows(s, idx),
                      lambda s=src: s[idx]))
    return cases


def _same(a, b) -> bool:
    if isinstance(a, tuple) or isinstance(b, tuple):
        return isinstance(a, tuple) and isinstance(b, tuple) and \
            len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and bool(np.array_equal(a, b))


def compare(n: int = 1 << 21, seed: int = 0) -> dict:
    """Every function on inputs of about n elements (seed `seed`), through
    the library and its NumPy path. Returns {"comparisons", "failures"
    (names), "seconds", "library" (its path)}; raises RuntimeError when
    the library did not build."""
    if not native.available():
        raise RuntimeError("the native library did not build")
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    failures, done = [], 0
    for name, call in _cases(n, rng):
        got = call()
        with fallback():
            want = call()
        done += 1
        if not _same(got, want):
            failures.append(name)
    for name, call, numpy_call in _direct_cases(n, rng):
        done += 1
        if not _same(call(), numpy_call()):
            failures.append(name)
    strings = [f"http://site{i % 971}.example.com/p/{i}?ref={i % 7}"
               for i in rng.integers(0, 1 << 30, FSST_STRINGS)]
    done += 1
    if _fsst(strings):
        failures.append("fsst round trip")
    return {"comparisons": done, "failures": failures,
            "seconds": time.perf_counter() - t0, "library": native._SO_PATH}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=1 << 21)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    try:
        res = compare(args.n, args.seed)
    except RuntimeError as e:
        print(f"native_check: {e}", file=sys.stderr)
        return 2
    print(f"native==numpy: {res['comparisons']} comparisons at n {args.n}, "
          f"{len(res['failures'])} differences {res['failures']}; "
          f"{res['seconds']:.2f} s", flush=True)
    return 1 if res["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
