"""The check sees each fault a cell can have: the run goes on with the
timed path broken underneath, and `correct` comes out false. (A one-chip
cell has no exchange between chips to leave out.)"""

import pytest

from adacom_tpu_torch.main import appender, connection, result
from test_mix_rehearsal import run

CELLS = ["lineitem_sf10.revenue"]


@pytest.mark.parametrize("cell_name", CELLS)
def test_half_the_rows_left_out(spec, monkeypatch, cell_name):
    real = appender.Appender.append_columns

    def half(self, data, validity=None):
        n = len(next(iter(data.values())))
        return real(self, {k: v[: n // 2] for k, v in data.items()}, validity)

    monkeypatch.setattr(appender.Appender, "append_columns", half)
    assert not run(spec, cell_name)["correct"]


@pytest.mark.parametrize("cell_name", CELLS)
def test_an_answer_altered(spec, monkeypatch, cell_name):
    real = result.QueryResult.fetchall
    calls = [0]

    def altered(self):
        rows = real(self)
        calls[0] += 1
        if calls[0] == 5 and rows:  # one answer of the window, by a part in 1e7
            first = list(rows[0])
            i = next(i for i, v in enumerate(first) if not isinstance(v, str))
            first[i] = float(first[i]) * (1 + 1e-7) + 1e-7
            rows = [tuple(first)] + list(rows[1:])
        return rows

    monkeypatch.setattr(result.QueryResult, "fetchall", altered)
    assert not run(spec, cell_name)["correct"]


@pytest.mark.parametrize("cell_name", CELLS)
def test_state_left_unchanged(spec, monkeypatch, cell_name):
    """Each connection answers every query of a template with its first
    answer."""
    real = connection.Connection.query

    def stale(self, sql):
        seen = self.__dict__.setdefault("_first", {})
        key = sql.split("WHERE")[0]
        if key not in seen:
            seen[key] = real(self, sql)
        return seen[key]

    monkeypatch.setattr(connection.Connection, "query", stale)
    assert not run(spec, cell_name, seconds=1.5)["correct"]
