"""Logical-plan (de)serialization to JSON-safe structures (port of
adacom_tpu/sql/serialize.py; the same SQL gives the same JSON in both
packages, but for BSubquery's `cached_value`, below).

Parity target: the reference's plan serializer used by the `deserialized`
statement verifier (src/verification/deserialized_statement_verifier.cpp
over the LogicalOperator::Serialize machinery in src/planner/operator/*)
and, looking forward, plan shipping for multi-host execution.

Every bound plan node / expression is a dataclass (sql/bound.py), so the
encoding is structural: {"__t": <class>, <field>: <value>...}. Special
encodings:
- LogicalType           -> {"__ty": [name, precision, scale]}
- storage Table         -> {"__table": name} (re-resolved via the catalog);
                           the anonymous table of a table function
                           (read_csv(...), range(...)) -> {"__table_fn":
                           [function, [args...], alias]}, which
                           deserialization calls again
- StringDictionary      -> {"__dict": ["table", tname, cname]} when it is
                           a table column's dictionary, else
                           {"__dict": ["inline", [strings...]]}
- np.ndarray (LUTs)     -> {"__nd": [dtype, [values...]]}
- tuples                -> {"__tuple": [...]}
A plan holds no runtime state: the executor evaluates subqueries per
execution. The JAX package's BSubquery still carries `cached_value`, so
its JSON for a plan with a subquery has that one key more (always null);
deserialization ignores a key that no field takes, so such a payload, and
one this package wrote before it dropped the field, still loads.
The side attribute `dicts` (output-column dictionaries) rides along when
present. `json.dumps(serialize_plan(p))` round-trips."""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from adacom_tpu_torch import types as tt
from adacom_tpu_torch.sql import bound as b
from adacom_tpu_torch.storage.table import StringDictionary

_NODE_TYPES = {
    cls.__name__: cls
    for cls in vars(b).values()
    if isinstance(cls, type) and (
        issubclass(cls, (b.LogicalOp, b.BExpr))
        or cls in (b.BoundAggregate, b.BoundWindow))
}


class SerializeError(Exception):
    pass


def serialize_plan(plan: b.LogicalOp, catalog=None) -> dict:
    return _enc(plan, _DictIndex(catalog))


def deserialize_plan(data: dict, catalog) -> b.LogicalOp:
    out = _dec(data, catalog)
    if not isinstance(out, b.LogicalOp):
        raise SerializeError("payload is not a logical plan")
    return out


class _DictIndex:
    """Maps StringDictionary objects back to their owning table column."""

    def __init__(self, catalog):
        self._by_id = {}
        if catalog is not None:
            for tname, table in catalog.tables.items():
                for cname in table.column_order:
                    d = table.columns[cname].dictionary
                    if d is not None:
                        self._by_id[id(d)] = (tname, cname)

    def ref(self, d: StringDictionary):
        return self._by_id.get(id(d))


def _enc(v: Any, idx: _DictIndex):
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.bool_):
        return bool(v)
    if isinstance(v, tt.LogicalType):
        return {"__ty": [v.name, v.precision, v.scale]}
    if isinstance(v, StringDictionary):
        ref = idx.ref(v)
        if ref is not None:
            return {"__dict": ["table", ref[0], ref[1]]}
        return {"__dict": ["inline", list(v._strings)]}
    if isinstance(v, np.ndarray):
        return {"__nd": [str(v.dtype), v.tolist()]}
    if isinstance(v, tuple):
        return {"__tuple": [_enc(x, idx) for x in v]}
    if isinstance(v, list):
        return [_enc(x, idx) for x in v]
    cls = type(v)
    if cls.__name__ in _NODE_TYPES and dataclasses.is_dataclass(v):
        out = {"__t": cls.__name__}
        for f in dataclasses.fields(v):
            fv = getattr(v, f.name)
            if isinstance(v, b.LogicalGet) and f.name == "table":
                source = getattr(fv, "source", None)
                out["table"] = {"__table": v.table_name} if source is None \
                    else {"__table_fn": [source[0], list(source[1]),
                                         v.table_name]}
                continue
            if isinstance(v, b.LogicalJoin) and f.name == "null_aware" \
                    and not fv:
                continue  # the JAX package's plans have no such field
            out[f.name] = _enc(fv, idx)
        dicts = getattr(v, "dicts", None)
        if dicts is not None:
            out["__dicts"] = [_enc(d, idx) for d in dicts]
        return out
    # dictionary-like duck types (e.g. derived output dictionaries from
    # BDictMap) expose _strings; inline them
    if hasattr(v, "_strings"):
        return {"__dict": ["inline", list(v._strings)]}
    raise SerializeError(f"cannot serialize {cls.__name__}: {v!r}")


def _dec(v: Any, catalog):
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, list):
        return [_dec(x, catalog) for x in v]
    if not isinstance(v, dict):
        raise SerializeError(f"cannot deserialize {v!r}")
    if "__ty" in v:
        name, prec, scale = v["__ty"]
        if name == "DECIMAL":
            return tt.DECIMAL(prec, scale)
        return tt.type_from_name(name)
    if "__dict" in v:
        kind = v["__dict"][0]
        if kind == "table":
            _, tname, cname = v["__dict"]
            return catalog.get_table(tname).columns[cname].dictionary
        d = StringDictionary()
        d.encode(v["__dict"][1])
        return d
    if "__nd" in v:
        dtype, vals = v["__nd"]
        return np.asarray(vals, dtype=np.dtype(dtype))
    if "__tuple" in v:
        return tuple(_dec(x, catalog) for x in v["__tuple"])
    if "__table" in v:
        return catalog.get_table(v["__table"])
    if "__table_fn" in v:
        from adacom_tpu_torch.sql.binder import Binder

        name, args, alias = v["__table_fn"]
        plan, _scope = Binder(catalog, catalog.config).table_function_plan(
            name, alias, args)
        plan.table.source = (name, args)
        return plan.table
    if "__t" in v:
        cls = _NODE_TYPES[v["__t"]]
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name in v:
                kwargs[f.name] = _dec(v[f.name], catalog)
        node = cls(**kwargs)
        if "__dicts" in v:
            node.dicts = [_dec(d, catalog) for d in v["__dicts"]]
        return node
    raise SerializeError(f"unknown payload {list(v)[:3]}")
