"""ctypes bindings to the native host runtime (native/adacom_native.cpp).

Port of adacom_tpu/native.py. The JAX package loads the committed
``native/libadacom_native.so``, which was built elsewhere with
``-march=native``; the port compiles ``native/adacom_native.cpp`` for the
machine it runs on into its own build directory on first use (build.py)
and loads that copy. Every function keeps the NumPy fallback used when no
C++ compiler is available; `available()` says which path is live."""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from adacom_tpu_torch import build

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_SO_PATH: Optional[str] = None

_i64 = ctypes.c_int64
_u64 = ctypes.c_uint64
_u32 = ctypes.c_uint32
_i32 = ctypes.c_int32
_int = ctypes.c_int
_dbl = ctypes.c_double
_p_u32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_p_u64 = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
_p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED, _SO_PATH
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        path = build.native_library()
        lib = ctypes.CDLL(path)
    except (build.BuildError, OSError):
        return None
    _SO_PATH = path
    lib.adacom_pack_u32.argtypes = [_p_u32, _i64, _int, _p_u32]
    lib.adacom_unpack_u32.argtypes = [_p_u32, _i64, _int, _p_u32]
    lib.adacom_gather_u32.argtypes = [_p_u32, _i64, _int, _p_i64, _i64, _p_u32]
    lib.adacom_filter_eq_u32.argtypes = [_p_u32, _i64, _u32, _p_i64]
    lib.adacom_filter_eq_u32.restype = _i64
    lib.adacom_filter_range_u32.argtypes = [_p_u32, _i64, _u32, _u32, _p_i64]
    lib.adacom_filter_range_u32.restype = _i64
    lib.adacom_filter_eq_i64.argtypes = [_p_i64, _i64, _i64, _p_i64]
    lib.adacom_filter_eq_i64.restype = _i64
    lib.adacom_packed_filter_eq_u32.argtypes = [_p_u32, _i64, _int, _u32, _u32, _p_i64]
    lib.adacom_packed_filter_eq_u32.restype = _i64
    lib.adacom_zipf_sample.argtypes = [_u64, _dbl, _u64, _i64, _p_i64]
    lib.adacom_groupby_i64.argtypes = [_p_i64, _i64, _p_i64, _p_i64]
    lib.adacom_groupby_i64.restype = _i64
    lib.adacom_group_sum_i64.argtypes = [_p_i64, _p_i64, _i64, _p_i64]
    lib.adacom_group_sum_f64.argtypes = [_p_i64, _p_f64, _i64, _p_f64]
    lib.adacom_argsort_u64.argtypes = [_p_u64, _i64, _p_i64]
    lib.adacom_join_build_i64.argtypes = [_p_i64, _i64]
    lib.adacom_join_build_i64.restype = ctypes.c_void_p
    lib.adacom_join_count_i64.argtypes = [ctypes.c_void_p, _p_i64, _i64,
                                          _p_i64]
    lib.adacom_join_emit_i64.argtypes = [ctypes.c_void_p, _p_i64, _i64,
                                         _p_i64, _p_i64, _p_i64]
    lib.adacom_join_free.argtypes = [ctypes.c_void_p]
    lib.adacom_filter_range_i64.argtypes = [_p_i64, _i64, _i64, _i64, _p_i64]
    lib.adacom_filter_range_i64.restype = _i64
    lib.adacom_filter_range_i32.argtypes = [_p_i32, _i64, _i32, _i32, _p_i64]
    lib.adacom_filter_range_i32.restype = _i64
    lib.adacom_groupby_i64_mt.argtypes = [_p_i64, _i64, _p_i64, _p_i64]
    lib.adacom_groupby_i64_mt.restype = _i64
    for nm in ("adacom_gather8", "adacom_gather4", "adacom_gather1"):
        fn = getattr(lib, nm)
        fn.argtypes = [ctypes.c_void_p, _p_i64, _i64, ctypes.c_void_p]
    _p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.adacom_fsst_train.argtypes = [_p_u8, _i64, _p_u8, _p_u8]
    lib.adacom_fsst_train.restype = _int
    lib.adacom_fsst_encode.argtypes = [_p_u8, _p_u8, _int, _p_u8, _p_i64,
                                       _i64, _p_u8, _i64, _p_i64]
    lib.adacom_fsst_encode.restype = _i64
    lib.adacom_fsst_decode.argtypes = [_p_u8, _p_u8, _int, _p_u8, _i64,
                                       _p_u8, _i64]
    lib.adacom_fsst_decode.restype = _i64
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


# ---------------- codec ----------------


def pack_u32(codes: np.ndarray, width: int) -> np.ndarray:
    """Host-side vertical-lane pack; layout-identical to ops/bitpack.pack."""
    codes = np.ascontiguousarray(codes, dtype=np.uint32)
    n = len(codes)
    L = max(1, (n + 31) // 32)
    lib = _load()
    if lib is None:
        from adacom_tpu_torch.ops.bitpack import pack_numpy

        return pack_numpy(codes, width)
    out = np.zeros((width, L), dtype=np.uint32)
    lib.adacom_pack_u32(codes, n, width, out)
    return out


def unpack_u32(words: np.ndarray, count: int, width: int) -> np.ndarray:
    words = np.ascontiguousarray(words, dtype=np.uint32)
    lib = _load()
    if lib is None:
        from adacom_tpu_torch.ops.bitpack import unpack_numpy

        return unpack_numpy(words, count, width)
    out = np.zeros(count, dtype=np.uint32)
    lib.adacom_unpack_u32(words, count, width, out)
    return out


def gather_u32(words: np.ndarray, n_lanes: int, width: int, idx: np.ndarray) -> np.ndarray:
    words = np.ascontiguousarray(words, dtype=np.uint32)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    lib = _load()
    if lib is None:
        from adacom_tpu_torch.ops.bitpack import unpack_numpy

        full = unpack_numpy(words, n_lanes * 32, width)
        return full[idx]
    out = np.zeros(len(idx), dtype=np.uint32)
    lib.adacom_gather_u32(words, n_lanes, width, idx, len(idx), out)
    return out


# ---------------- filters ----------------


_tls = __import__("threading").local()


def _scratch_i64(n: int) -> np.ndarray:
    """Per-thread reusable index buffer (callers copy the filled prefix)."""
    buf = getattr(_tls, "idx_buf", None)
    if buf is None or len(buf) < n:
        buf = _tls.idx_buf = np.empty(max(n, 1 << 16), dtype=np.int64)
    return buf


_eq_u32_raw = None


def filter_eq_u32(vals: np.ndarray, v: int) -> np.ndarray:
    lib = _load()
    if lib is None or vals.dtype != np.uint32 or \
            not vals.flags.c_contiguous:
        vals = np.ascontiguousarray(vals, dtype=np.uint32)
        if lib is None:
            return np.nonzero(vals == np.uint32(v))[0]
    # raw-address call: ndpointer from_param validation costs ~10us per
    # call, real money at 10k point lookups/s
    global _eq_u32_raw
    if _eq_u32_raw is None:
        raw = ctypes.CDLL(_SO_PATH).adacom_filter_eq_u32
        raw.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32,
                        ctypes.c_void_p]
        raw.restype = ctypes.c_int64
        _eq_u32_raw = raw
    idx = _scratch_i64(len(vals))
    m = _eq_u32_raw(vals.ctypes.data, len(vals), v & 0xFFFFFFFF,
                    idx.ctypes.data)
    return idx[:m].copy()


def packed_filter_eq_u32(words: np.ndarray, count: int, width: int,
                         min_factor: int, v: int) -> np.ndarray:
    """Point-lookup scan DIRECTLY over packed host words (no decode pass).
    Returns the matching row indices in ascending order on both paths (the
    library walks the words lane by lane, so its hits are sorted here)."""
    lib = _load()
    words = np.ascontiguousarray(words, dtype=np.uint32)
    if lib is None:
        from adacom_tpu_torch.ops.bitpack import unpack_numpy

        vals = unpack_numpy(words, count, width).astype(np.uint64) + min_factor
        return np.nonzero(vals == v)[0]
    idx = np.empty(count, dtype=np.int64)
    m = lib.adacom_packed_filter_eq_u32(words, count, width,
                                        np.uint32(min_factor), np.uint32(v), idx)
    return np.sort(idx[:m])


# ---------------- grouped aggregation / sort ----------------


def groupby_i64(keys: np.ndarray):
    """Hash-table factorization (GroupedAggregateHashTable parity): returns
    (gid per row, first-occurrence row index per group) in first-seen
    group order."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    lib = _load()
    if lib is None:
        _, first_idx, gid = np.unique(keys, return_index=True,
                                      return_inverse=True)
        # re-rank to first-occurrence order for determinism parity
        order = np.argsort(first_idx, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        return rank[gid].astype(np.int64), first_idx[order]
    n = len(keys)
    gid = np.empty(n, dtype=np.int64)
    first = np.empty(n, dtype=np.int64)
    n_groups = lib.adacom_groupby_i64_mt(keys, n, gid, first)
    return gid, first[:n_groups]


def group_sum(gid: np.ndarray, vals: np.ndarray, n_groups: int) -> np.ndarray:
    """Exact grouped sum (int64 accumulators for integer/decimal inputs)."""
    gid = np.ascontiguousarray(gid, dtype=np.int64)
    lib = _load()
    if vals.dtype.kind in "iu":
        vals = np.ascontiguousarray(vals, dtype=np.int64)
        if lib is None:
            out = np.zeros(n_groups, dtype=np.int64)
            np.add.at(out, gid, vals)
            return out
        out = np.zeros(n_groups, dtype=np.int64)
        lib.adacom_group_sum_i64(gid, vals, len(vals), out)
        return out
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    if lib is None:
        out = np.zeros(n_groups, dtype=np.float64)
        np.add.at(out, gid, vals)
        return out
    out = np.zeros(n_groups, dtype=np.float64)
    lib.adacom_group_sum_f64(gid, vals, len(vals), out)
    return out


def argsort_u64(keys: np.ndarray) -> np.ndarray:
    """Stable LSD radix argsort (reference RadixSort parity). Keys must be
    order-preserving u64 (caller maps signed/float)."""
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    lib = _load()
    if lib is None:
        return np.argsort(keys, kind="stable")
    out = np.empty(len(keys), dtype=np.int64)
    lib.adacom_argsort_u64(keys, len(keys), out)
    return out


# ---------------- workloads ----------------


def zipf_sample(n: int, q: float, seed: int, size: int) -> np.ndarray:
    lib = _load()
    if lib is None:
        from adacom_tpu_torch.bench.zipf import ZipfSampler

        return ZipfSampler(n, q, seed).sample(size)
    out = np.empty(size, dtype=np.int64)
    lib.adacom_zipf_sample(np.uint64(n), float(q), np.uint64(seed), size, out)
    return out


class JoinTable:
    """Persistent native chained-bucket hash table (reference
    JoinHashTable): build once, probe per morsel — the handle the
    streaming pipeline keeps across probe chunks."""

    def __init__(self, build_keys: np.ndarray):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self._build = np.ascontiguousarray(build_keys, dtype=np.int64)
        self._ht = self._lib.adacom_join_build_i64(self._build,
                                                   len(self._build))

    def probe(self, probe_keys: np.ndarray):
        """-> (probe_idx, build_idx) matching pairs for this chunk."""
        probe = np.ascontiguousarray(probe_keys, dtype=np.int64)
        counts = np.empty(len(probe), dtype=np.int64)
        self._lib.adacom_join_count_i64(self._ht, probe, len(probe), counts)
        total = int(counts.sum())
        offsets = np.zeros(len(probe), dtype=np.int64)
        if len(probe):
            np.cumsum(counts[:-1], out=offsets[1:])
        li = np.empty(total, dtype=np.int64)
        ri = np.empty(total, dtype=np.int64)
        self._lib.adacom_join_emit_i64(self._ht, probe, len(probe),
                                       offsets, li, ri)
        return li, ri

    def close(self):
        if getattr(self, "_ht", None):
            self._lib.adacom_join_free(self._ht)
            self._ht = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def hash_join_i64(build_keys: np.ndarray, probe_keys: np.ndarray):
    """All matching (probe_idx, build_idx) pairs for i64 equi-keys via a
    chained-bucket hash table with threaded probes (reference
    JoinHashTable Build/Probe, join_hashtable.cpp:197,415). Returns None
    when the native library is unavailable — callers fall back to the
    sort-probe join."""
    lib = _load()
    if lib is None:
        return None
    build = np.ascontiguousarray(build_keys, dtype=np.int64)
    probe = np.ascontiguousarray(probe_keys, dtype=np.int64)
    ht = lib.adacom_join_build_i64(build, len(build))
    try:
        counts = np.empty(len(probe), dtype=np.int64)
        lib.adacom_join_count_i64(ht, probe, len(probe), counts)
        total = int(counts.sum())
        offsets = np.zeros(len(probe), dtype=np.int64)
        if len(probe):
            np.cumsum(counts[:-1], out=offsets[1:])
        li = np.empty(total, dtype=np.int64)
        ri = np.empty(total, dtype=np.int64)
        lib.adacom_join_emit_i64(ht, probe, len(probe), offsets, li, ri)
        return li, ri
    finally:
        lib.adacom_join_free(ht)


def filter_range_i64(vals: np.ndarray, lo: int, hi: int) -> Optional[np.ndarray]:
    """Indices of lo <= v <= hi (inclusive); None -> caller uses numpy."""
    lib = _load()
    if lib is None:
        return None
    vals = np.ascontiguousarray(vals, dtype=np.int64)
    out = _scratch_i64(len(vals))
    m = lib.adacom_filter_range_i64(vals, len(vals), int(lo), int(hi), out)
    return out[:m].copy()


def filter_range_i32(vals: np.ndarray, lo: int, hi: int) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    vals = np.ascontiguousarray(vals, dtype=np.int32)
    out = _scratch_i64(len(vals))
    m = lib.adacom_filter_range_i32(vals, len(vals), int(lo), int(hi), out)
    return out[:m].copy()


def gather_rows(src: np.ndarray, idx: np.ndarray) -> Optional[np.ndarray]:
    """Threaded out[j] = src[idx[j]] for 1/4/8-byte element dtypes; None ->
    caller uses numpy fancy indexing."""
    lib = _load()
    if lib is None:
        return None
    if src.ndim != 1:
        return None
    item = src.dtype.itemsize
    if item not in (1, 4, 8):
        return None
    src = np.ascontiguousarray(src)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    out = np.empty(len(idx), dtype=src.dtype)
    fn = {8: lib.adacom_gather8, 4: lib.adacom_gather4,
          1: lib.adacom_gather1}[item]
    fn(src.ctypes.data_as(ctypes.c_void_p), idx, len(idx),
       out.ctypes.data_as(ctypes.c_void_p))
    return out


# ---------------- FSST-class string compression ----------------


def fsst_train(corpus: np.ndarray):
    """Train a symbol table on a byte corpus; returns (symtab (254,8) u8,
    symlens (254,) u8, n_symbols) or None without the .so."""
    lib = _load()
    if lib is None:
        return None
    corpus = np.ascontiguousarray(corpus, dtype=np.uint8)
    symtab = np.zeros((254, 8), dtype=np.uint8)
    symlens = np.zeros(254, dtype=np.uint8)
    n = lib.adacom_fsst_train(corpus, len(corpus), symtab.reshape(-1),
                              symlens)
    return symtab, symlens, int(n)


def fsst_encode(symtab, symlens, n_sym, corpus: np.ndarray,
                offs: np.ndarray):
    """Encode n strings (corpus + n+1 offsets) -> (blob u8, out_offs) or
    None without the .so."""
    lib = _load()
    if lib is None:
        return None
    corpus = np.ascontiguousarray(corpus, dtype=np.uint8)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    n_str = len(offs) - 1
    cap = max(16, 2 * len(corpus) + 2 * n_str)
    out = np.empty(cap, dtype=np.uint8)
    out_offs = np.empty(n_str + 1, dtype=np.int64)
    w = lib.adacom_fsst_encode(symtab.reshape(-1), symlens, int(n_sym),
                               corpus, offs, n_str, out, cap, out_offs)
    if w < 0:
        return None
    return out[:w].copy(), out_offs


def fsst_decode(symtab, symlens, n_sym, blob: np.ndarray) -> bytes:
    """Decode one encoded string's bytes."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    blob = np.ascontiguousarray(blob, dtype=np.uint8)
    cap = max(16, 8 * len(blob))
    out = np.empty(cap, dtype=np.uint8)
    w = lib.adacom_fsst_decode(symtab.reshape(-1), symlens, int(n_sym),
                               blob, len(blob), out, cap)
    if w < 0:
        raise ValueError("corrupt FSST stream")
    return out[:w].tobytes()
