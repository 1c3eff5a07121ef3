"""Each cell's control, the plain reference computed in float32 in the
program's place, comes out as not correct under the cell's limits."""

import pytest

from benchmark import control, registry
from conftest import small_desc


@pytest.mark.parametrize("cell_name", ["lineitem_sf10.revenue"])
def test_control_is_not_correct(spec, cell_name):
    cell = registry.cell(spec, cell_name)
    desc = small_desc(spec, cell["config"])
    out = control.readings(spec, cell, 2**31 + 5, 20, desc=desc)
    assert out["answers"] > 0 and not out["correct"], out
