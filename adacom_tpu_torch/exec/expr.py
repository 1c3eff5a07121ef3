"""Expression compiler: bound expressions -> numpy closures.

Port of adacom_tpu/exec/expr.py with host (numpy) evaluation only.

Parity with the reference ExpressionExecutor (src/execution/
expression_executor.cpp): vectorized evaluation over column batches with
NULL (three-valued) semantics carried as (value, validity) pairs.

Plan-cache support: literals that came from the SQL text are *dynamic
inputs* (transformed host-side by `prep`, e.g. string -> dictionary code),
so a compiled expression is reused across queries that differ only in
literal values (the reference re-plans every query)."""

from __future__ import annotations

import fnmatch
import re
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from adacom_tpu_torch import types as tt
from adacom_tpu_torch.sql import bound as b


def _xp(v):
    """Array module for an evaluated value. Expressions run on the host in
    numpy in this slice of the port; the torch expression tier comes with
    the generic device path (ROADMAP queue A)."""
    return np

# an evaluated expression: (values array, validity bool array or None)
EV = Tuple[Any, Optional[Any]]


def _and_valid(a: Optional[Any], c: Optional[Any]) -> Optional[Any]:
    if a is None:
        return c
    if c is None:
        return a
    return a & c


def compute_dtype_of(ty: tt.LogicalType) -> np.dtype:
    from adacom_tpu_torch.storage.segment import compute_dtype_for

    return compute_dtype_for(ty.np_dtype)


def like_to_regex(pattern: str) -> str:
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return "^" + "".join(out) + "$"


class CompiledExpr:
    """fn(cols, args) -> (values, valid); prep(lits, ctx) -> dynamic args."""

    def __init__(self, fn, preps, ty):
        self.fn = fn
        self.preps = preps  # list of callables(lits) -> host value
        self.ty = ty

    def prep_args(self, lits: List[Any]) -> tuple:
        return tuple(p(lits) for p in self.preps)


class ExprCompiler:
    """Compiles one expression tree; dynamic inputs are appended to `preps`
    and delivered positionally in `args` at trace time."""

    def __init__(self):
        self.preps: List[Callable] = []

    # -------------- public --------------
    def compile(self, e: b.BExpr) -> CompiledExpr:
        fn = self._c(e)
        return CompiledExpr(fn, self.preps, e.ty)

    # -------------- dynamic input helpers --------------
    def _add_input(self, prep: Callable) -> int:
        self.preps.append(prep)
        return len(self.preps) - 1

    # -------------- compile nodes --------------
    def _c(self, e: b.BExpr) -> Callable:
        if isinstance(e, b.BColumn):
            idx = e.index

            def fn(cols, args):
                return cols[idx]

            return fn

        if isinstance(e, b.BLiteral):
            return self._c_literal(e)

        if isinstance(e, b.BBinary):
            return self._c_binary(e)

        if isinstance(e, b.BUnary):
            cf = self._c(e.operand)
            if e.op == "-":
                def fn(cols, args):
                    v, m = cf(cols, args)
                    return -v, m
                return fn

            def fn(cols, args):
                v, m = cf(cols, args)
                return ~v.astype(np.bool_), m
            return fn

        if isinstance(e, b.BIsNull):
            cf = self._c(e.operand)
            neg = e.negated

            def fn(cols, args):
                v, m = cf(cols, args)
                if m is None:
                    xp = _xp(v)
                    shape = v.shape
                    r = xp.zeros(shape, np.bool_) if not neg else xp.ones(shape, np.bool_)
                else:
                    r = m if neg else ~m
                return r, None
            return fn

        if isinstance(e, b.BCast):
            cf = self._c(e.operand)
            src_ty = e.operand.ty
            dst_ty = e.ty
            dst = compute_dtype_of(dst_ty)
            # decimal rescaling
            scale_mul = 1
            scale_div = 1
            if dst_ty.name == "DECIMAL" and src_ty.name == "DECIMAL":
                if dst_ty.scale > src_ty.scale:
                    scale_mul = 10 ** (dst_ty.scale - src_ty.scale)
                else:
                    scale_div = 10 ** (src_ty.scale - dst_ty.scale)
            elif dst_ty.name == "DECIMAL" and src_ty.integer:
                scale_mul = 10 ** dst_ty.scale
            elif dst_ty.name == "DECIMAL" and src_ty.is_float:
                def fn(cols, args):
                    v, m = cf(cols, args)
                    return _xp(v).round(v * (10 ** dst_ty.scale)).astype(dst), m
                return fn
            elif dst_ty.is_float and src_ty.name == "DECIMAL":
                div = 10.0 ** src_ty.scale

                def fn(cols, args):
                    v, m = cf(cols, args)
                    return v.astype(dst) / div, m
                return fn

            def fn(cols, args):
                v, m = cf(cols, args)
                if scale_mul != 1:
                    v = v.astype(dst) * scale_mul
                elif scale_div != 1:
                    v = (v // scale_div).astype(dst)
                else:
                    v = v.astype(dst)
                return v, m
            return fn

        if isinstance(e, b.BCase):
            whens = [(self._c(c), self._c(v)) for c, v in e.whens]
            elsef = self._c(e.else_) if e.else_ is not None else None
            dst = compute_dtype_of(e.ty)

            def fn(cols, args):
                conds = []
                for cf, vf in whens:
                    cv, cm = cf(cols, args)
                    vv, vm = vf(cols, args)
                    conds.append((cv if cm is None else (cv & cm), vv, vm))
                xp = _xp(conds[0][0]) if conds else np
                if elsef is not None:
                    acc, accm = elsef(cols, args)
                else:
                    ref = conds[0][1]
                    acc = xp.zeros(np.shape(ref), dtype=dst)
                    accm = xp.zeros(np.shape(acc), np.bool_)  # NULL else
                acc = acc.astype(dst) if hasattr(acc, "astype") else acc
                for cv, vv, vm in reversed(conds):
                    acc = xp.where(cv, vv.astype(dst) if hasattr(vv, "astype") else vv, acc)
                    if accm is not None or vm is not None:
                        am = accm if accm is not None else xp.ones(np.shape(acc), np.bool_)
                        wm = vm if vm is not None else xp.ones(np.shape(acc), np.bool_)
                        accm = xp.where(cv, wm, am)
                return acc, accm
            return fn

        if isinstance(e, b.BInList):
            cf = self._c(e.operand)
            # string IN list: compare dictionary codes
            dict_ = getattr(e.operand, "dictionary", None)
            item_fns = []
            for it in e.items:
                if isinstance(it, b.BLiteral) and dict_ is not None and isinstance(it.value, (str,)) or (
                    isinstance(it, b.BLiteral) and it.param is not None and dict_ is not None and e.operand.ty.is_string
                ):
                    item_fns.append(self._c_string_code(it, dict_))
                else:
                    item_fns.append(self._c(it))
            neg = e.negated

            def fn(cols, args):
                v, m = cf(cols, args)
                acc = None
                for itf in item_fns:
                    iv, im = itf(cols, args)
                    hit = v == iv
                    acc = hit if acc is None else (acc | hit)
                if neg:
                    acc = ~acc
                return acc, m
            return fn

        if isinstance(e, b.BDictPredicate):
            return self._c_dict_predicate(e)

        if isinstance(e, b.BDictMap):
            # string fn evaluated over the dictionary at bind time: runtime
            # is just an old-code -> new-code LUT gather
            cf = self._c(e.operand)
            lut = np.asarray(e.lut, dtype=np.uint32)

            def fn(cols, args):
                v, m = cf(cols, args)
                if isinstance(v, np.ndarray):
                    return lut[np.minimum(v, lut.shape[0] - 1)], m
                t = np.asarray(lut)
                return t[np.minimum(v, t.shape[0] - 1)], m
            return fn

        if isinstance(e, b.BDictIntMap):
            # integer string fn (length/strpos/ascii): per-code int LUT
            cf = self._c(e.operand)
            lut = np.asarray(e.lut, dtype=np.int64)
            if lut.size == 0:
                lut = np.zeros(1, dtype=np.int64)

            def fn(cols, args):
                v, m = cf(cols, args)
                if isinstance(v, np.ndarray):
                    return lut[np.minimum(v, lut.shape[0] - 1)], m
                t = np.asarray(lut)
                return t[np.minimum(v, t.shape[0] - 1)], m
            return fn

        if isinstance(e, b.BCodeDict):
            # operand already yields codes into e.dictionary
            cf = self._c(e.operand)

            def fn(cols, args):
                v, m = cf(cols, args)
                return v.astype(np.uint32), m
            return fn

        if isinstance(e, b.BFunc):
            return self._c_func(e)

        if isinstance(e, b.BAggRef):
            idx = e.index

            def fn(cols, args):
                return cols[idx]
            return fn

        if isinstance(e, b.BSubquery):
            node = e
            if e.kind in ("scalar", "exists"):
                dt = compute_dtype_of(e.ty)

                def prep(lits):
                    v = node.cached_value
                    if v is None:
                        # NULL scalar result
                        return np.asarray(np.nan if np.dtype(dt).kind == "f" else 0, dtype=dt)
                    return np.asarray(v, dtype=dt)

                k = self._add_input(prep)
                is_null = e.kind == "scalar"

                def fn(cols, args):
                    if is_null and node.cached_value is None:
                        return args[k], np.zeros((), np.bool_)
                    return args[k], None
                return fn

            # 'in' used outside a top-level filter conjunct: membership via
            # a sorted cached array + searchsorted
            opf = self._c(e.operand)
            neg = e.negated

            def prep(lits):
                arr = node.cached_value
                if arr is None or len(arr) == 0:
                    return np.zeros(1, dtype=compute_dtype_of(node.operand.ty))
                return np.sort(np.asarray(arr))

            k = self._add_input(prep)

            def fn(cols, args):
                v, m = opf(cols, args)
                arr = args[k]
                xp = _xp(v)
                idx = xp.clip(xp.searchsorted(arr, v), 0, arr.shape[0] - 1)
                hit = arr[idx] == v
                if node.cached_value is None or len(node.cached_value) == 0:
                    hit = xp.zeros_like(hit)
                return (~hit if neg else hit), m
            return fn

        raise NotImplementedError(f"cannot compile {type(e).__name__}")

    # -------------- literals --------------
    def _c_literal(self, e: b.BLiteral) -> Callable:
        if e.value is None and e.param is None:
            def fn(cols, args):
                return np.zeros((), np.int32), np.zeros((), np.bool_)
            return fn
        dt = compute_dtype_of(e.ty)
        if e.param is not None:
            slot = e.param
            ty = e.ty

            def prep(lits):
                v = lits[slot]
                if ty is tt.DATE and isinstance(v, str):
                    from adacom_tpu_torch.sql.binder import days_from_iso

                    return np.asarray(days_from_iso(v), dtype=dt)
                if isinstance(v, str):
                    return v  # strings resolved by comparison context
                return np.asarray(v, dtype=dt)

            k = self._add_input(prep)

            def fn(cols, args):
                return args[k], None
            return fn
        val = e.value
        if isinstance(val, str):
            def fn(cols, args):
                return val, None
            return fn
        # np scalar: works as a traced constant on device AND keeps the
        # host-tier numpy evaluation path in numpy
        const = np.asarray(val, dtype=dt)

        def fn(cols, args):
            return const, None
        return fn

    def _c_string_code(self, lit: b.BLiteral, dict_) -> Callable:
        """String literal -> dictionary code (dynamic; -1 when absent)."""
        if lit.param is not None:
            slot = lit.param

            def prep(lits):
                code = dict_.lookup(str(lits[slot]))
                return np.asarray(0xFFFFFFFF if code is None else code, dtype=np.uint32)
        else:
            sval = str(lit.value)

            def prep(lits):
                code = dict_.lookup(sval)
                return np.asarray(0xFFFFFFFF if code is None else code, dtype=np.uint32)
        k = self._add_input(prep)

        def fn(cols, args):
            return args[k], None
        return fn

    # -------------- binary ops --------------
    def _c_binary(self, e: b.BBinary) -> Callable:
        op = e.op
        l, r = e.left, e.right

        if op in ("and", "or"):
            lf, rf = self._c(l), self._c(r)
            if op == "and":
                def fn(cols, args):
                    lv, lm = lf(cols, args)
                    rv, rm = rf(cols, args)
                    v = lv & rv
                    # 3VL: null unless any side is definite false
                    if lm is None and rm is None:
                        return v, None
                    lmv = np.ones(lv.shape, np.bool_) if lm is None else lm
                    rmv = np.ones(rv.shape, np.bool_) if rm is None else rm
                    definite_false = ((~lv) & lmv) | ((~rv) & rmv)
                    valid = (lmv & rmv) | definite_false
                    return v, valid
                return fn

            def fn(cols, args):
                lv, lm = lf(cols, args)
                rv, rm = rf(cols, args)
                v = lv | rv
                if lm is None and rm is None:
                    return v, None
                lmv = np.ones(lv.shape, np.bool_) if lm is None else lm
                rmv = np.ones(rv.shape, np.bool_) if rm is None else rm
                definite_true = (lv & lmv) | (rv & rmv)
                valid = (lmv & rmv) | definite_true
                return v, valid
            return fn

        # string comparison against a literal -> dictionary-code comparison
        if op in ("=", "<>") and (l.ty.is_string or r.ty.is_string):
            col, lit = (l, r) if isinstance(r, b.BLiteral) else (r, l)
            dict_ = getattr(col, "dictionary", None)
            if isinstance(lit, b.BLiteral) and dict_ is not None:
                colf = self._c(col)
                litf = self._c_string_code(lit, dict_)
                neg = op == "<>"

                def fn(cols, args):
                    v, m = colf(cols, args)
                    code, _ = litf(cols, args)
                    hit = v == code
                    return (~hit if neg else hit), m
                return fn

        # string ordering comparisons need rank transforms (later milestone)
        lf, rf = self._c(l), self._c(r)

        if op in ("=", "<>", "<", "<=", ">", ">="):
            # promote to a common comparable dtype; decimals with unequal
            # scales (or vs plain numerics) compare in float64 after
            # descaling each side
            cdt = self._promote(l.ty, r.ty)
            l_s = l.ty.scale if l.ty.name == "DECIMAL" else 0
            r_s = r.ty.scale if r.ty.name == "DECIMAL" else 0
            l_num = l.ty.integer or l.ty.is_float
            r_num = r.ty.integer or r.ty.is_float
            descale = (l_s != r_s) or (
                (l_s or r_s) and (l.ty.is_float or r.ty.is_float or
                                  (l_num and r_num and (l.ty.name == "DECIMAL") != (r.ty.name == "DECIMAL")))
            )
            ldiv = 10.0 ** l_s
            rdiv = 10.0 ** r_s

            def fn(cols, args):
                lv, lm = lf(cols, args)
                rv, rm = rf(cols, args)
                if descale:
                    lv = lv.astype(np.float64) / ldiv if hasattr(lv, "astype") else lv / ldiv
                    rv = rv.astype(np.float64) / rdiv if hasattr(rv, "astype") else rv / rdiv
                else:
                    lv = lv.astype(cdt) if hasattr(lv, "astype") else lv
                    rv = rv.astype(cdt) if hasattr(rv, "astype") else rv
                if op == "=":
                    v = lv == rv
                elif op == "<>":
                    v = lv != rv
                elif op == "<":
                    v = lv < rv
                elif op == "<=":
                    v = lv <= rv
                elif op == ">":
                    v = lv > rv
                else:
                    v = lv >= rv
                return v, _and_valid(lm, rm)
            return fn

        # arithmetic
        res_dt = compute_dtype_of(e.ty)
        l_scale = l.ty.scale if l.ty.name == "DECIMAL" else 0
        r_scale = r.ty.scale if r.ty.name == "DECIMAL" else 0
        res_float = np.dtype(res_dt).kind == "f"

        def fn(cols, args):
            lv, lm = lf(cols, args)
            rv, rm = rf(cols, args)
            m = _and_valid(lm, rm)
            if res_float and (l_scale or r_scale):
                # float result: descale decimal operands up front
                if l_scale:
                    lv = lv.astype(np.float64) / (10.0 ** l_scale)
                if r_scale:
                    rv = rv.astype(np.float64) / (10.0 ** r_scale)
                if op == "+":
                    return lv + rv, m
                if op == "-":
                    return lv - rv, m
                if op == "*":
                    return lv * rv, m
                if op == "/":
                    return lv / rv, m
                if op == "%":
                    return lv % rv, m
            if op == "+":
                if l_scale or r_scale:
                    s = max(l_scale, r_scale)
                    return (lv.astype(res_dt) * (10 ** (s - l_scale))
                            + rv.astype(res_dt) * (10 ** (s - r_scale))), m
                return lv.astype(res_dt) + rv.astype(res_dt), m
            if op == "-":
                if l_scale or r_scale:
                    s = max(l_scale, r_scale)
                    return (lv.astype(res_dt) * (10 ** (s - l_scale))
                            - rv.astype(res_dt) * (10 ** (s - r_scale))), m
                return lv.astype(res_dt) - rv.astype(res_dt), m
            if op == "*":
                return lv.astype(res_dt) * rv.astype(res_dt), m
            if op == "/":
                if np.dtype(res_dt).kind == "f":
                    ldiv = lv.astype(res_dt) / (10.0 ** l_scale)
                    rdiv = rv.astype(res_dt) / (10.0 ** r_scale)
                    return ldiv / rdiv, m
                return lv.astype(res_dt) // rv.astype(res_dt), m
            if op == "%":
                return lv.astype(res_dt) % rv.astype(res_dt), m
            raise NotImplementedError(op)
        return fn

    def _promote(self, a: tt.LogicalType, c: tt.LogicalType) -> np.dtype:
        if a.name == "DECIMAL" or c.name == "DECIMAL":
            # compare decimals at common scale in float64 when scales differ;
            # equal scales compare as int64
            if a.scale == c.scale:
                return np.dtype(np.int64)
            return np.dtype(np.float64)
        if a.is_float or c.is_float:
            return np.dtype(np.float64)
        da, dc = compute_dtype_of(a), compute_dtype_of(c)
        if da == dc:
            return da
        # mixed signed/unsigned or width: widen to int64
        if da.kind == dc.kind:
            return da if da.itemsize >= dc.itemsize else dc
        return np.dtype(np.int64)

    # -------------- dict predicates (LIKE) --------------
    def _c_dict_predicate(self, e: b.BDictPredicate) -> Callable:
        dict_ = e.dictionary
        colf = self._c(e.operand)
        pat = e.pattern
        neg = e.negated
        ci = e.case_insensitive

        if pat.param is not None:
            slot = pat.param

            def get_pat(lits):
                return str(lits[slot])
        else:
            pval = str(pat.value)

            def get_pat(lits):
                return pval

        kind = getattr(e, "kind", "like")

        def prep(lits):
            pattern = get_pat(lits)
            flags = re.IGNORECASE if ci else 0
            if kind == "regex":
                # regexp_matches: partial match anywhere (re.search)
                rx = re.compile(pattern, flags)
                hit = rx.search
            else:
                rx = re.compile(like_to_regex(pattern), flags)
                hit = rx.match
            strs = dict_.strings_array()
            lut = np.fromiter(
                (hit(s) is not None for s in strs),
                dtype=np.bool_, count=len(strs),
            )
            if len(lut) == 0:
                lut = np.zeros(1, dtype=np.bool_)
            return lut

        k = self._add_input(prep)

        def fn(cols, args):
            v, m = colf(cols, args)
            lut = args[k]
            hit = lut[_xp(v).minimum(v, lut.shape[0] - 1)]
            if neg:
                hit = ~hit
            return hit, m
        return fn

    # -------------- scalar functions --------------
    def _c_func(self, e: b.BFunc) -> Callable:
        name = e.name
        afs = [self._c(a) for a in e.args]
        if name == "abs":
            def fn(cols, args):
                v, m = afs[0](cols, args)
                return np.abs(v), m
            return fn
        if name in ("floor", "ceil", "ceiling"):
            f = np.floor if name == "floor" else np.ceil

            def fn(cols, args):
                v, m = afs[0](cols, args)
                return f(v), m
            return fn
        if name == "round":
            def fn(cols, args):
                v, m = afs[0](cols, args)
                if len(afs) > 1:
                    d, _ = afs[1](cols, args)
                    mul = 10.0 ** d
                    return np.round(v * mul) / mul, m
                return np.round(v), m
            return fn
        if name in ("sqrt", "exp", "ln", "log10", "log2", "sin", "cos",
                    "tan", "asin", "acos", "atan", "cbrt"):
            f = {"sqrt": np.sqrt, "exp": np.exp, "ln": np.log,
                 "log10": np.log10, "log2": np.log2, "sin": np.sin,
                 "cos": np.cos, "tan": np.tan, "asin": np.arcsin,
                 "acos": np.arccos, "atan": np.arctan,
                 "cbrt": np.cbrt}[name]

            def fn(cols, args):
                v, m = afs[0](cols, args)
                return f(v.astype(np.float64)), m
            return fn
        if name in ("degrees", "radians"):
            k = 180.0 / np.pi if name == "degrees" else np.pi / 180.0

            def fn(cols, args):
                v, m = afs[0](cols, args)
                return v.astype(np.float64) * np.float64(k), m
            return fn
        if name in ("power", "atan2"):
            f = np.power if name == "power" else np.arctan2

            def fn(cols, args):
                x, mx = afs[0](cols, args)
                y, my = afs[1](cols, args)
                return (f(x.astype(np.float64), y.astype(np.float64)),
                        _and_mask(mx, my))
            return fn
        if name == "sign":
            def fn(cols, args):
                v, m = afs[0](cols, args)
                return np.sign(v).astype(np.int64), m
            return fn
        if name == "trunc":
            def fn(cols, args):
                v, m = afs[0](cols, args)
                return np.trunc(v.astype(np.float64)), m
            return fn
        if name == "mod":
            def fn(cols, args):
                x, mx = afs[0](cols, args)
                y, my = afs[1](cols, args)
                m = _and_mask(mx, my)
                if np.dtype(x.dtype).kind == "f" or \
                        np.dtype(y.dtype).kind == "f":
                    xf = x.astype(np.float64)
                    yf = y.astype(np.float64)
                    r = xf - np.trunc(xf / yf) * yf  # C fmod semantics
                    bad = yf == np.float64(0.0)
                else:
                    safe = np.where(y == 0, np.ones_like(y), y)
                    r = x % safe
                    # % follows the divisor's sign; SQL mod follows the
                    # dividend's (truncated division)
                    fix = (r != 0) & ((r < 0) != (x < 0))
                    r = np.where(fix, r - safe, r)
                    bad = y == 0
                ones = np.ones(r.shape, np.bool_)
                m2 = (ones if m is None else m) & ~bad
                return r, m2
            return fn
        if name in ("greatest", "least"):
            is_g = name == "greatest"

            def fn(cols, args):
                # Postgres/DuckDB semantics: NULL args ignored; NULL only
                # when every argument is NULL
                v, m = afs[0](cols, args)
                for af in afs[1:]:
                    nv, nm = af(cols, args)
                    pick = nv > v if is_g else nv < v
                    if nm is not None:
                        pick = pick & nm
                    if m is not None:
                        pick = pick | ~m
                    v = np.where(pick, nv.astype(v.dtype), v)
                    if m is None or nm is None:
                        m = None
                    else:
                        m = m | nm
                return v, m
            return fn
        if name in ("extract_year", "extract_month", "extract_day",
                    "extract_quarter", "extract_week", "extract_dow",
                    "extract_doy", "extract_epoch", "extract_hour",
                    "extract_minute", "extract_second"):
            part = name.split("_")[1]
            is_ts = getattr(e.args[0], "ty", None) is not None and \
                e.args[0].ty.name == "TIMESTAMP"

            def fn(cols, args):
                v, m = afs[0](cols, args)
                if is_ts:
                    us = v.astype(np.int64)
                    if part == "epoch":
                        return us // np.int64(1_000_000), m
                    if part == "hour":
                        return (us // np.int64(3_600_000_000)) % np.int64(24), m
                    if part == "minute":
                        return (us // np.int64(60_000_000)) % np.int64(60), m
                    if part == "second":
                        return (us // np.int64(1_000_000)) % np.int64(60), m
                    days = us // np.int64(86_400_000_000)
                else:
                    days = v.astype(np.int64)
                    if part in ("hour", "minute", "second"):
                        return _xp(days).zeros_like(days), m
                if part == "epoch":
                    return days * np.int64(86400), m
                if part == "dow":
                    # Sunday = 0 (1970-01-01 was a Thursday -> 4)
                    return (days + np.int64(4)) % np.int64(7), m
                if part == "week":
                    return _iso_week(days), m
                y, mo, d = _civil_from_days(days)
                if part == "quarter":
                    out = (mo + 2) // 3
                elif part == "doy":
                    out = days - _days_from_civil(y, _xp(mo).ones_like(mo),
                                                  _xp(d).ones_like(d)) + 1
                else:
                    out = {"year": y, "month": mo, "day": d}[part]
                return out.astype(np.int64), m
            return fn
        if name == "date_trunc":
            # bound as date_trunc with args = [part literal, date]; the
            # binder folds the part into the name? no — literal arg 0
            is_ts = getattr(e.args[1], "ty", None) is not None and \
                e.args[1].ty.name == "TIMESTAMP"

            def fn_factory(part):
                def fn(cols, args):
                    v, m = afs[1](cols, args)
                    if is_ts:
                        us = v.astype(np.int64)
                        step = {"second": 1_000_000,
                                "minute": 60_000_000,
                                "hour": 3_600_000_000,
                                "day": 86_400_000_000}.get(part)
                        if step is not None:
                            return us - us % np.int64(step), m
                        # month/year/...: truncate in day space, back to us
                        days = us // np.int64(86_400_000_000)
                        y, mo, d = _civil_from_days(days)
                        one = _xp(mo).ones_like(mo)
                        if part == "month":
                            out = _days_from_civil(y, mo, one)
                        elif part == "quarter":
                            qm = ((mo - 1) // 3) * 3 + 1
                            out = _days_from_civil(y, qm, one)
                        elif part == "week":
                            out = days - (days + np.int64(3)) % np.int64(7)
                        else:  # year
                            out = _days_from_civil(y, one, one)
                        return out * np.int64(86_400_000_000), m
                    days = v.astype(np.int64)
                    if part == "day":
                        return days.astype(np.int32), m
                    if part == "week":
                        # truncate to Monday
                        return (days - (days + np.int64(3)) %
                                np.int64(7)).astype(np.int32), m
                    y, mo, d = _civil_from_days(days)
                    one = _xp(mo).ones_like(mo)
                    if part == "month":
                        out = _days_from_civil(y, mo, one)
                    elif part == "quarter":
                        qm = ((mo - 1) // 3) * 3 + 1
                        out = _days_from_civil(y, qm, one)
                    else:  # year
                        out = _days_from_civil(y, one, one)
                    return out.astype(np.int32), m
                return fn
            part = e.args[0]
            pv = str(part.value).lower() if isinstance(part, b.BLiteral) \
                else "day"
            return fn_factory(pv)
        if name == "last_day":
            def fn(cols, args):
                v, m = afs[0](cols, args)
                y, mo, d = _civil_from_days(v.astype(np.int64))
                tot = y * 12 + mo  # first of next month
                out = _days_from_civil(tot // 12, tot % 12 + 1,
                                       _xp(d).ones_like(d)) - 1
                return out.astype(np.int32), m
            return fn
        if name in ("date_diff_day", "date_diff_month", "date_diff_year"):
            part = name.split("_")[2]

            def fn(cols, args):
                a, ma = afs[0](cols, args)
                c, mc = afs[1](cols, args)
                m = _and_mask(ma, mc)
                da = a.astype(np.int64)
                dc = c.astype(np.int64)
                if part == "day":
                    return dc - da, m
                ya, moa, _ = _civil_from_days(da)
                yc, moc, _ = _civil_from_days(dc)
                if part == "month":
                    return (yc * 12 + moc) - (ya * 12 + moa), m
                return yc - ya, m
            return fn
        if name == "date_add":
            def fn(cols, args):
                v, m = afs[0](cols, args)
                months, _ = afs[1](cols, args)
                days, _ = afs[2](cols, args)
                # month arithmetic on device: convert to civil, add, rebuild
                y, mo, d = _civil_from_days(v.astype(np.int64))
                tot = y * 12 + (mo - 1) + months
                y2 = tot // 12
                mo2 = tot % 12 + 1
                out = _days_from_civil(y2, mo2, d) + days
                return out.astype(np.int32), m
            return fn
        if name == "coalesce":
            def fn(cols, args):
                v, m = afs[0](cols, args)
                for af in afs[1:]:
                    nv, nm = af(cols, args)
                    if m is None:
                        break
                    xp = _xp(v) if not isinstance(nv, np.ndarray) or isinstance(v, np.ndarray) else np
                    v = xp.where(m, v, nv)
                    m = m | (xp.ones(np.shape(v), np.bool_) if nm is None else nm)
                return v, m
            return fn
        raise NotImplementedError(f"function {name}")


def _and_mask(a, b_):
    """Combine validity masks (None = all valid)."""
    if a is None:
        return b_
    if b_ is None:
        return a
    return a & b_


def _iso_week(days):
    """ISO-8601 week number from days-since-epoch (vectorized)."""
    dow_mon0 = (days + np.int64(3)) % np.int64(7)  # Monday = 0
    thursday = days - dow_mon0 + np.int64(3)
    y, _, _ = _civil_from_days(thursday)
    jan1 = _days_from_civil(y, _xp(y).ones_like(y), _xp(y).ones_like(y))
    return (thursday - jan1) // np.int64(7) + np.int64(1)


# --- Howard Hinnant's civil-date algorithms, vectorized (branch-free) ----


def _civil_from_days(z):
    xp = _xp(z)
    z = z + 719468
    era = xp.where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = xp.where(mp < 10, mp + 3, mp - 9)
    y = xp.where(m <= 2, y + 1, y)
    return y, m, d


def _days_from_civil(y, m, d):
    xp = _xp(y)
    y = xp.where(m <= 2, y - 1, y)
    era = xp.where(y >= 0, y, y - 399) // 400
    yoe = y - era * 400
    mp = xp.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468
