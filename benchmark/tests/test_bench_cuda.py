"""On the card, at the cells' own sizes: the program reads within the
limits and the control and every planted fault read beyond them, on three
seeds; a short run of each cell is correct. Skips without a CUDA device
(``python -m pytest benchmark/tests/test_bench_cuda.py`` on the card)."""

import time

import pytest

from benchmark import harness
from benchmark.tools import control

CELLS = ["caustics.progressive", "scaled.progressive"]
SEEDS = [2**31 + 101, 2**31 + 102, 2**31 + 103]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_at_the_cells_size(cuda_device, name):
    cell = harness.load_cell(name, 0, 0.0, False, "cuda")
    limits = cell.workload["limits"]
    for seed in SEEDS:
        r = control.readings(cell, seed)
        assert all(r["program"][k] <= limits[k] for k in limits), (seed, r["program"])
        for side in r:
            if side != "program":
                assert any(r[side][k] > limits[k] for k in limits), (seed, side, r[side])


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_short_run_is_correct(cuda_device, name):
    result, _ = harness.run_cell(harness.load_cell(name, SEEDS[0], 2.0, False, "cuda"), time.perf_counter())
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert result["counters"]["k1_launches"] == result["counters"]["passes"]
