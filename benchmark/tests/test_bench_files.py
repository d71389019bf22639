"""Every configuration, traffic, workload, engine and metric file loads,
and BENCHMARK.json names only what exists and keeps the contract's forms."""

import json
import re

import pytest

from benchmark import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"][1].startswith("benchmark/")
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"} and NAME.match(cfg["name"])
    assert cfg["source"].startswith("https://") and len(cfg["source"]) <= 200 and len(cfg["why"]) <= 200
    data = harness.load_json(harness.ROOT / cfg["file"])
    assert data["name"] == cfg["name"] and data["reduced"] == cfg["reduced"] == []
    assert (harness.HERE / data["scene"]).is_file()
    assert {"width", "height", "spp", "max_depth", "estimator", "precision", "assumed"} <= set(data)


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"} and NAME.match(cell["name"])
    assert cell["config"] in {c["name"] for c in BENCH["configs"]} and cell["chips"] in (1, 4)
    assert len(cell["why"]) <= 200 and "\n" not in cell["why"]
    traffic = harness.load_json(harness.HERE / "traffic" / f"{cell['traffic']}.json")
    assert (harness.HERE / "jobs" / f"{traffic['job']}.py").is_file()
    workload = harness.load_json(harness.HERE / "workloads" / f"{cell['name']}.json")
    assert workload["engine"] in ("auto", *[p.stem for p in (harness.HERE / "engines").glob("*.json")])
    assert set(workload["limits"]) == {"px_gap", "mean_gap"} and all(v > 0 for v in workload["limits"].values())
    reports = {m["name"] for m in METRICS if "workloads" not in m or cell["name"] in m["workloads"]}
    assert "setup_s" in reports and len(reports & {m["name"] for m in BENCH["end_to_end"]}) >= 2
    assert reports & {m["name"] for m in BENCH["per_layer"]}


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric(m):
    keys = {"name", "unit", "better", "source"}
    keys |= {"bound"} if m in BENCH["end_to_end"] else {"layer", "moves"}
    assert set(m) - {"workloads"} == keys and NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert callable(harness.load_module(harness.HERE / "metrics" / f"{m['name']}.py").read)
    if m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    else:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for w in m.get("workloads", []):
        assert w in {c["name"] for c in BENCH["workloads"]}


@pytest.mark.parametrize("path", sorted((harness.HERE / "engines").glob("*.json")), ids=lambda p: p.stem)
def test_engine_entries_resolve(path):
    spec = harness.load_json(path)
    assert callable(harness.resolve(spec["entry"]))
    for target in spec.get("counters", {}).values():
        assert isinstance(harness.resolve(target), int)
