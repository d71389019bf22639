"""A run on the CPU at a small size (the harness's look for a card left
out): correct as it stands, and not correct with the timed path broken
underneath, once for each fault the cells can have."""

import time

import numpy as np
import pytest

from benchmark import harness
from benchmark.reference import scene, walk
from benchmark.tests.conftest import SMALL, small_cell
from benchmark.tools import control, faults

CELLS = ["caustics.progressive", "scaled.progressive"]


def _run(cell):
    result, lines = harness.run_cell(cell, time.perf_counter())
    assert result["attempted"] >= 2, "the test wants the window's first two batches checked"
    return result


def _brightest_lane(cell) -> int:
    rs = scene.load_packed(harness.HERE / cell.config["scene"], SMALL["width"] / SMALL["height"], "cpu")
    est = walk.Estimator(max_depth=cell.config["max_depth"], **cell.config["estimator"])
    ref = walk.batch_image(rs, cell.seed, 0, cell.traffic["batch_passes"], SMALL["width"], SMALL["height"],
                           SMALL["spp"], est)
    return int(np.argmax(ref[..., :3].sum(-1).numpy()))


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result = _run(small_cell(name))
    assert result["correct"] and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert all(c["value"] == 0.0 for c in result["checks"].values())
    assert set(result["metrics"]) == {"samples_per_s", "batch_ms_p95", "setup_s"}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(faults.WRAPS))
def test_broken_batch_is_not_correct(name, fault):
    result = _run(small_cell(name, wrap_entry=faults.WRAPS[fault]))
    assert not result["correct"] and result["failed"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_altered_answer_is_not_correct(name):
    cell = small_cell(name)
    with faults.altered_lane(_brightest_lane(cell)):
        result = _run(cell)
    assert not result["correct"]


def test_traced_run_reports_per_layer_metrics():
    result = _run(small_cell("caustics.progressive", trace=True))
    assert result["correct"]
    assert "busy_s" in result["device"] and "window_s" in result["device"]
    assert "wrapper_ms_per_pass" in result["metrics"]
    # no card: no device time, so none of the device's metrics
    assert not {"k1_ms_per_pass", "k1_roofline", "device_idle_pct"} & set(result["metrics"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_exceed_the_limits(name):
    """The control (the reference in bfloat16) and each planted fault fail
    one of the cell's numbers; the program reads within them."""
    cell = small_cell(name)
    limits = cell.workload["limits"]
    r = control.readings(cell, 2**31 + 3)
    assert all(r["program"][k] <= limits[k] for k in limits)
    for side in r:
        if side != "program":
            assert any(r[side][k] > limits[k] for k in limits), side
