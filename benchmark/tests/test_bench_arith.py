"""The metric arithmetic gives the worked answers."""

import math

import numpy as np
import pytest

from benchmark import bounds, check, harness, stats, trace


def test_percentile():
    assert stats.percentile(list(range(1, 101)), 95) == pytest.approx(95.05)


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (8, 12)]
    assert stats.union_length(iv) == 3 + 1 + 4
    assert stats.union_length(iv, 2, 10) == 1 + 1 + 2
    assert stats.gaps(iv, -1, 10) == [(-1, 0), (3, 5), (6, 8)]


def _x(name, ts, dur, cat):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def test_trace_slice_from_synthetic_events():
    """Two batches of 10 ms; the card busy 6 ms in each (a kernel of 4 ms
    and a copy of 2 ms); idle while the host is in the wrapper (2 ms a
    batch) and in its sum (2 ms a batch): one gap of 2 ms, then one of
    4 ms across the first batch's sum and the second's wrapper, then 2 ms."""
    events = []
    for b in range(2):
        t = b * 10_000.0
        events += [
            _x("bench.batch", t, 10_000, "user_annotation"),
            _x("bench.wrapper", t, 3_000, "user_annotation"),
            _x("bench.copy", t + 3_000, 5_000, "user_annotation"),
            _x("bench.host_sum", t + 8_000, 2_000, "user_annotation"),
            _x("void megakernel_lanes<true>(float const*)", t + 2_000, 4_000, "kernel"),
            _x("Memcpy DtoH (Device -> Pageable)", t + 6_000, 2_000, "gpu_memcpy"),
            _x("aten::add_", t + 8_100, 100, "cpu_op"),
        ]
    sl = trace.summarise(events)
    assert sl.window_s == pytest.approx(0.020)
    assert sl.busy_s == pytest.approx(0.012)
    assert sl.idle_s == pytest.approx({"wrapper": 0.004, "host_sum": 0.004})
    rec = harness.Record(None, "NVIDIA H100 80GB HBM3", 1.0, 0.02,
                         [harness.Request(100.0, 4, {"wrapper": 0.003}, True, 10.0) for _ in range(2)],
                         {}, sl, {})
    read = {m: harness.load_module(harness.HERE / "metrics" / f"{m}.py").read(rec)
            for m in ("device_idle_pct", "k1_ms_per_pass", "samples_per_s", "batch_ms_p95", "wrapper_ms_per_pass")}
    assert read == pytest.approx({"device_idle_pct": 40.0, "k1_ms_per_pass": 1.0, "samples_per_s": 10_000.0,
                                  "batch_ms_p95": 10.0, "wrapper_ms_per_pass": 0.75})
    bd = trace.breakdown(sl)
    assert bd["device_ops"][0] == ["void megakernel_lanes<true>(float const*)", pytest.approx(0.008)]
    assert sorted(g[0] for g in bd["idle_gaps"]) == ["host in host_sum (2 gaps)", "host in wrapper (2 gaps)"]


def test_k1_bound_from_fixed_stats():
    """One pass of 100 lanes x 4 samples on a rigid scene of 2 planes and
    3 spheres, counts over 2 passes."""
    shape = {"n_lanes": 100, "eff": 4, "n_planes": 2, "n_spheres": 3, "rigid": True, "packed_floats": 200}
    counts = {"rays": 2000, "shadow_rays": 600, "hits": 1800, "lambert": 400, "phong": 100, "mirror": 100,
              "transmit": 50}
    n_bytes, n_ops = bounds.k1_work(shape, counts, passes=2)
    per_ray = 2 * 14 + 3 * 25
    tests = (1000 + 300) * per_ray + 3 * 6
    shading = 400 * 35 + 1000 * 8 + 100 * 6 + 900 * 46 + (400 * 69 + 100 * 96 + 100 * 13 + 50 * 36 + 600 * 92) / 2
    assert n_bytes == 200 * 4 + 12 * 100
    assert n_ops == pytest.approx(tests + shading)
    peak = bounds.peaks("NVIDIA H100 80GB HBM3")
    ms, by = bounds.bound_ms(n_bytes, n_ops, peak)
    assert by == "operations" and ms == pytest.approx((tests + shading) / 67e12 * 1e3)
    assert bounds.peaks("cpu") is None
    rec = harness.Record(None, "NVIDIA H100 80GB HBM3", 1.0, 1.0,
                         [harness.Request(1.0, 1, {}, True)], {},
                         trace.Slice(1.0, 0.5, {"megakernel_lanes": 2 * ms / 1e3}, {}, {}),
                         {"k1_pass": dict(shape, stats=counts, passes=2)})
    pct = harness.load_module(harness.HERE / "metrics" / "k1_roofline.py").read(rec)
    assert pct == pytest.approx(50.0)


def test_gaps_worked():
    ref = np.ones((2, 2, 4), np.float32)
    start = np.full_like(ref, 3.0)
    assert check.gaps(start + ref, start, ref) == {"px_gap": 0.0, "mean_gap": 0.0}
    after = start + ref
    after[0, 0, 0] += 0.5
    g = check.gaps(after, start, ref)
    assert g == pytest.approx({"px_gap": 0.5, "mean_gap": 0.5 / 16})
    after[1, 1, 1] = np.nan
    assert check.gaps(after, start, ref)["px_gap"] == math.inf
    judged = check.judge({"px_gap": 0.1}, {"px_gap": 0.2, "mean_gap": 0.1})
    assert judged["mean_gap"]["value"] == math.inf and not check.passed(judged)
    assert check.passed(check.judge({"px_gap": 0.2, "mean_gap": 0.0}, {"px_gap": 0.2, "mean_gap": 0.1}))
