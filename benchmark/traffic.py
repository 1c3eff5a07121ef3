"""The one general generator of traffic.

A mix is a JSON file, ``traffic/<mix>.json``:

    {"clients": [{"count": 3, "templates": ["revenue"], "requests": 4096}],
     "templates": {"revenue": {"answer": "tpch_revenue_top",
                               "reads": ["lineitem.l_suppkey", "..."],
                               "params": {...}, "sql": ["SELECT ...", "..."]}}}

Each client is a closed loop that sends its templates in turn, starting at
its own index, and draws every parameter from the seed before the window:
client c's stream depends only on (seed, c), so the same seed gives the
same requests whatever the timing. A stream of `requests` requests
repeats from its start if a client gets through it.

Parameters, drawn in the order the template lists them:
  {"int": [lo, hi]}               uniform integer, both ends included
  {"zipf": [n, q]}                bounded Zipf in [1, n]; n may name a size
                                  of the configuration
  {"date": [base, y, m, d]}       ISO date: base (ISO or a parameter) plus
                                  y years, m months, d days; each an
                                  integer or a parameter, "-name" negates
  {"decimal": [name, add, scale]} the parameter plus `add`, as a decimal
                                  literal with `scale` digits
The "answer" names the reference's function; "reads" lists the
``table.column`` that the query must read on the device (none for a
lookup the host tier answers)."""

from __future__ import annotations

import calendar
import datetime

import numpy as np

from benchmark.zipf import ZipfSampler


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one stream of a run: any whole seed, negative or
    past 64 bits, maps to the same words each time."""
    return np.random.default_rng([seed % (1 << 64), *stream])


class Template:
    def __init__(self, name: str, spec: dict, sizes: dict):
        self.name = name
        self.answer = spec["answer"]
        sql = spec["sql"]
        self.sql = "\n".join(sql) if isinstance(sql, list) else sql
        self.reads = list(spec.get("reads", []))
        self.params = dict(spec.get("params", {}))
        self.sizes = sizes
        for pname, p in self.params.items():
            if len(p) != 1 or next(iter(p)) not in ("int", "zipf", "date", "decimal"):
                raise ValueError(f"template {name}: parameter {pname}: {p}")

    def draw(self, rng: np.random.Generator, n: int) -> dict:
        """Arrays of the drawn parameters for n requests."""
        out = {}
        for pname, p in self.params.items():
            kind, arg = next(iter(p.items()))
            if kind == "int":
                out[pname] = rng.integers(arg[0], arg[1] + 1, n)
            elif kind == "zipf":
                size = arg[0] if isinstance(arg[0], int) else self.sizes[arg[0]]
                out[pname] = ZipfSampler(int(size), float(arg[1]), rng).sample(n)
        return out

    def params_at(self, drawn: dict, k: int) -> dict:
        """The k-th request's parameters, the derived ones included."""
        vals = {}
        for pname, p in self.params.items():
            kind, arg = next(iter(p.items()))
            if kind in ("int", "zipf"):
                vals[pname] = int(drawn[pname][k])
            elif kind == "date":
                vals[pname] = _shift(_ref(arg[0], vals), *(_num(a, vals) for a in arg[1:]))
            else:
                v = _num(arg[0], vals) + arg[1]
                vals[pname] = _decimal(v, arg[2])
        return vals

    def sql_for(self, params: dict) -> str:
        return self.sql.format(**params)


def _ref(a, vals):
    return vals[a] if a in vals else a


def _num(a, vals) -> int:
    if isinstance(a, int):
        return a
    return -vals[a[1:]] if a.startswith("-") else vals[a]


def _shift(base: str, years: int, months: int, days: int) -> str:
    d = datetime.date.fromisoformat(base)
    y, m = divmod(d.year * 12 + d.month - 1 + years * 12 + months, 12)
    day = min(d.day, calendar.monthrange(y, m + 1)[1])
    return (datetime.date(y, m + 1, day) + datetime.timedelta(days=days)).isoformat()


def _decimal(v: int, scale: int) -> str:
    sign = "-" if v < 0 else ""
    q, r = divmod(abs(v), 10 ** scale)
    return f"{sign}{q}.{r:0{scale}d}" if scale else f"{sign}{q}"


class ClientStream:
    """One client's requests: its templates in turn from `offset`."""

    def __init__(self, templates: list, drawn: list, n: int, offset: int):
        self.templates = templates
        self.drawn = drawn
        self.n = n
        self.offset = offset

    def request(self, k: int):
        """(template, params, sql) of the client's k-th request."""
        k %= self.n
        slot = (self.offset + k) % len(self.templates)
        tpl = self.templates[slot]
        params = tpl.params_at(self.drawn[slot], self._index(k, slot))
        return tpl, params, tpl.sql_for(params)

    def _index(self, k: int, slot: int) -> int:
        """How many requests of template `slot` come before request k."""
        t = len(self.templates)
        first = (slot - self.offset) % t
        return 0 if k < first else (k - first) // t


class Mix:
    def __init__(self, spec: dict, sizes: dict):
        self.spec = spec
        self.templates = {name: Template(name, t, sizes)
                          for name, t in spec["templates"].items()}
        for c in spec["clients"]:
            for name in c["templates"]:
                if name not in self.templates:
                    raise KeyError(f"client template {name!r} is not defined")

    def clients(self, seed: int) -> list:
        """One ClientStream per client of the mix, drawn from the seed."""
        out = []
        for group in self.spec["clients"]:
            tpls = [self.templates[n] for n in group["templates"]]
            n = int(group["requests"])
            for _ in range(int(group["count"])):
                c = len(out)
                rng = rng_for(seed, 1 + c)
                drawn = [tpl.draw(rng, -(-n // len(tpls))) for tpl in tpls]
                out.append(ClientStream(tpls, drawn, n, c % len(tpls)))
        return out

    def warmup(self, seed: int) -> list:
        """One request of each template the mix sends: (template, params,
        sql)."""
        rng = rng_for(seed, 0)
        reqs = []
        for tpl in self.templates.values():
            params = tpl.params_at(tpl.draw(rng, 1), 0)
            reqs.append((tpl, params, tpl.sql_for(params)))
        return reqs
