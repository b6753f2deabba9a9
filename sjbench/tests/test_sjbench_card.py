"""Each cell for a short window on the card, held to its limits (run on
the card with ``PYTHONPATH=src python -m pytest -m gpu sjbench/tests``)."""
from __future__ import annotations

import time

import pytest
import torch

from sjbench import harness

CELLS = [w["name"] for w in harness.load_spec()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_sjbench_cell_runs_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = harness.Cell(harness.load_spec(), cell)
    result, run = harness.execute(c, 2**31 + 101, 0.5, False, torch.device("cuda", 0),
                                  time.perf_counter())
    assert result["correct"], result["checks"]
    assert run.steps >= 1 and result["device"]["platform"] == "gpu"
