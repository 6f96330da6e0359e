"""A short run of each cell on the card at a small X (skipped without one):
the kernels' route, the trace and the check end to end."""

import time

import pytest

from h100bench.harness import bench, main
from h100bench.tests.conftest import tiny

CELLS = [w["name"] for w in bench.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name):
    out = main.execute(tiny(name), 2 ** 31 + 3, 1.0, True, card,
                       time.perf_counter(), bench.benchmark(),
                       log=lambda s: None)
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
    assert out["device"]["platform"] == "gpu"
