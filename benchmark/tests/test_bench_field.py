"""The field cell (``procedural100k.progressive8``) on the CPU at a small
size: a 2,048-sphere field (streamed, through the plain K5/K6), 16x12,
batches of 2 passes. Correct as it stands, not correct with the timed
path broken underneath; its per-layer metrics; its set-up stops at once on
a port without the wavefront's counters; the roofline's arithmetic."""

import json
import time

import pytest

from benchmark import bounds, bounds_stream, harness, trace
from benchmark.tools import control_field, faults

CELL = "procedural100k.progressive8"
SMALL = {"width": 16, "height": 12}


@pytest.fixture(scope="module")
def small_scene(tmp_path_factory):
    """The cell's scene file with 2,048 spheres in place of 100,000."""
    path = tmp_path_factory.mktemp("field") / "field2048.json"
    scene = harness.load_json(harness.HERE / "scenes" / "procedural100k.json")
    path.write_text(json.dumps(dict(scene, n_spheres=2048)))
    return str(path)


def small_field_cell(scene: str, seed: int = 2**31 + 5, seconds: float = 1.5, trace: bool = False, **overrides):
    cfg = harness.load_json(harness.HERE / "configs" / "procedural100k.json")
    cfg.update(SMALL, scene=scene)  # an absolute path: HERE / scene is the path itself
    cell = harness.load_cell(CELL, seed, seconds, trace, "cpu", config=cfg, **overrides)
    cell.traffic = dict(cell.traffic, check_batches=[[0, 1], [1, 2]], warmup_s=0.0, batch_passes=2)
    return cell


def _run(cell):
    result, _ = harness.run_cell(cell, time.perf_counter())
    assert result["attempted"] >= 2, "the test wants the window's first two batches checked"
    return result


def test_sound_run_is_correct(small_scene):
    result = _run(small_field_cell(small_scene))
    assert result["correct"] and result["failed"] == 0
    assert all(c["value"] == 0.0 for c in result["checks"].values())
    assert set(result["metrics"]) == {"samples_per_s", "batch_ms_p95", "setup_s"}
    counters = result["counters"]
    assert counters["iterations"] > 0 and counters["flag_reads"] > counters["iterations"]
    assert counters["prepare_seconds"] > 0 and counters["k5_launches"] == 0  # the plain K5 on the CPU


@pytest.mark.parametrize("fault", sorted(faults.WRAPS))
def test_broken_batch_is_not_correct(small_scene, fault):
    result = _run(small_field_cell(small_scene, wrap_entry=faults.WRAPS[fault]))
    assert not result["correct"] and result["failed"] >= 1


def test_altered_lane_is_not_correct(small_scene):
    """The lane of the first batch's first pass that sums the most light,
    doubled in every pass (the small image is one tile, all checked)."""
    cell = small_field_cell(small_scene)
    job = harness.load_module(harness.HERE / "jobs" / "progressive_field.py").Job(cell)
    job.setup()
    lane = control_field.brightest_lane(job, 0, range(SMALL["width"] * SMALL["height"]))
    with control_field.altered_lane(lane):
        result = _run(cell)
    assert not result["correct"]


def test_traced_run_reports_the_fields_metrics(small_scene):
    result = _run(small_field_cell(small_scene, trace=True, seconds=4.0))
    assert result["correct"]
    assert {"stream_prepare_ms_per_batch", "wavefront_iters_per_pass"} <= set(result["metrics"])
    assert result["metrics"]["wavefront_iters_per_pass"]["value"] == 3.0  # depth 2, a sample a lane
    # no card: no device time, so none of the kernels' metrics
    assert not {"k5_ms_per_pass", "k5_roofline", "k6_ms_per_pass", "k6_roofline"} & set(result["metrics"])


def test_control_and_faults_exceed_the_limits(small_scene):
    cell = small_field_cell(small_scene)
    limits = cell.workload["limits"]
    r = control_field.readings(cell, 2**31 + 3)
    assert all(r["program"][k] == 0.0 for k in limits)
    for side in r:
        if side not in ("program", "seconds"):
            assert any(r[side][k] > limits[k] for k in limits), side


def test_setup_stops_on_a_port_without_the_counters(small_scene, monkeypatch):
    from kajo_tpu_torch.models import wavefront

    monkeypatch.delattr(wavefront, "iterations")
    job = harness.load_module(harness.HERE / "jobs" / "progressive_field.py").Job(small_field_cell(small_scene))
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="iterations"):
        job.setup()
    assert time.perf_counter() - t0 < 5.0


def test_stream_bound_from_fixed_counts():
    """A pass of one K5 and one K6 call on a rigid field of 10 blocks,
    counted on a sample of a sixteenth of the lanes."""
    nearest = {"kind": "nearest", "pairs": 300, "touched": 6, "live": 100, "rays": 120, "fields": 4, "blocks": 10}
    occluded = dict(nearest, kind="occluded", pairs=50, touched=3, live=40)
    n_bytes, n_ops = bounds_stream.call_work(nearest, 16)
    assert n_bytes == 10 * 32 + 6 * 128 * 16 + 16 * (100 * 24 + 120 * 12)
    assert n_ops == 16 * 300 * 128 * 25 + 6 * 128 * 6
    peak = bounds.peaks("NVIDIA H100 80GB HBM3")
    sp = {"calls": [nearest, occluded], "scale": 16, "passes": 1}
    want = bounds.bound_ms(n_bytes, n_ops, peak)[0]
    assert bounds_stream.pass_bound_ms(sp, "nearest", peak) == pytest.approx(want)
    assert bounds_stream.pass_bound_ms(dict(sp, calls=[nearest]), "occluded", peak) is None
    rec = harness.Record(None, "NVIDIA H100 80GB HBM3", 1.0, 1.0, [harness.Request(1.0, 1, {}, True)], {},
                         trace.Slice(1.0, 0.5, {"void nearest_kernel<true>(float const*)": 4 * want / 1e3}, {}, {}),
                         {"stream_pass": sp})
    pct = harness.load_module(harness.HERE / "metrics" / "k5_roofline.py").read(rec)
    assert pct == pytest.approx(25.0)
