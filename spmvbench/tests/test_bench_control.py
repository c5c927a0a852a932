"""The lower-precision control of each cell comes out as not correct, and
the program as correct, on the card at a size a test run holds (the chip
readings at the cells' own sizes are in PERF.md).  The harness's own
runs never run the control.

    python -m pytest -p no:cacheprovider spmvbench/tests -m cuda
"""

import time

import pytest

from spmvbench import core
from spmvbench.tests.helpers import CELLS, MEDIUM, cell_spec


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [7, 2**31 + 5, 4_000_000_001])
def test_control_fails_program_passes(cuda_device, cell, seed):
    spec = cell_spec(cell, MEDIUM)
    sound = core.run_cell(spec, seed, 1.0, 0, cuda_device,
                          time.perf_counter())
    control = core.run_cell(spec, seed, 1.0, 0, cuda_device,
                            time.perf_counter(),
                            control=spec["limits"]["control"])
    assert sound["correct"] is True, sound["checks"]
    assert control["correct"] is False, control["checks"]
