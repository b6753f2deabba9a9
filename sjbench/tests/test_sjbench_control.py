"""The control of each cell at a size a test run holds: the plain reference
in the program's place, computed in the precision below the configuration's,
fails the cell's limits (``sjbench/control.py`` runs it on the card at the
cell's own size)."""
from __future__ import annotations

import pytest

from sjbench import harness

SMALL = {
    "dblp_titles.scan": ({"rows": 1 << 10}, {"call_rows": 1 << 8}),
    "yfcc.scan": ({"rows": 1 << 10}, {"call_rows": 1 << 8}),
    "dblp_titles.sample_query": ({"rows": 1 << 11, "width": 64}, {"streams": 4, "round_rows": 32}),
}


@pytest.mark.parametrize("cell", list(SMALL))
def test_sjbench_control_fails_the_limits(cell):
    config, traffic = cell.split(".")
    entry = {"name": cell, "config": config, "traffic": traffic, "chips": 1}
    c = harness.Cell(harness.load_spec(), entry, *SMALL[cell])
    kind = harness.load_module("kinds", c.traffic["kind"])
    nums = kind.control(c, 2**31 + 3, "cpu")
    assert set(nums) == set(c.traffic["limits"])
    assert any(v > c.traffic["limits"][k] for k, v in nums.items()), nums
