"""The benchmark's driver: one run of one cell.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` finds the cell in ``BENCHMARK.json``, its configuration in
``configs/``, its traffic mix in ``traffic/``, its engine and limits in
``workloads/`` and the job that drives its traffic in ``jobs/<job>.py``.
It then

1. sets up: the job loads the scene through the port, picks the engine and
   warms up the shapes of the cell's traffic (``setup_s`` runs from the
   process's start to the first timed request);
2. measures for ``--seconds``: a closed loop of one client, each request
   run to its end before the next is sent; with ``--trace 1`` a
   ``torch.profiler`` slice records the window's last requests
   (``benchmark/trace.py``);
3. reads the device's memory peak, frees the program's state, and has the
   job compare what the window produced with the plain reference
   (``benchmark/check.py``, ``benchmark/reference/``);
4. reads each of the cell's metrics with its reader,
   ``metrics/<metric>.py`` (end-to-end ones with ``--trace 0``, per-layer
   ones with ``--trace 1``), and prints one JSON line last on standard
   output, with each compared number beside its limit last on standard
   error and last in that line.

Without a CUDA device, or with fewer than the cell asks for, it exits 2
and prints no result. It exits 3, and prints no result, if ``jax``,
``jaxlib``, ``flax`` or the JAX package ``kajo_tpu`` is among the loaded
modules once the window has closed (by top-level name, so
``kajo_tpu_torch`` is not ``kajo_tpu``).

The caches a run may write stay in the checkout's ``build/`` (the port
builds its kernels into ``build/kernels/``); profiler traces go to
``TMPDIR`` and are deleted once read.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

from . import check
from . import trace as trace_mod

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "kajo_tpu")
CACHE_ENV = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions", "CUDA_CACHE_PATH": "cuda"}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """The module in the file ``path``, loaded by its path (a name of a
    metric or job may hold dots)."""
    name = "benchmark._loaded." + path.parent.name + "." + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def resolve(target: str):
    """``"package.module:attribute"`` -> the attribute."""
    module, attr = target.split(":")
    return getattr(importlib.import_module(module), attr)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    """One cell and one run's settings. ``wrap_entry`` (tests only) wraps
    the engine's batch entry; ``engine`` overrides the workload's."""

    name: str
    seed: int
    seconds: float
    trace: bool
    device: str
    entry: dict  # the cell's entry of BENCHMARK.json
    config: dict
    traffic: dict
    workload: dict
    bench: dict
    wrap_entry: object = None
    engine: str | None = None


@dataclasses.dataclass
class Request:
    work: float  # units of the rate metric (samples)
    passes: int
    spans: dict  # span name -> host seconds
    traced: bool
    latency_ms: float | None = None


@dataclasses.dataclass
class Record:
    """What a run measured; the metric readers read it."""

    cell: Cell
    device_name: str
    setup_s: float
    window_s: float
    requests: list
    counters: dict
    slice: trace_mod.Slice | None
    extra: dict


class SpanClock:
    """Host seconds per span name of one request; with ``annotate``, each
    span is also a ``bench.<name>`` annotation in the profiler's trace."""

    def __init__(self, annotate: bool):
        self.seconds = {}
        self.annotate = annotate

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.annotate:
            from torch.profiler import record_function

            mark = record_function(trace_mod.PREFIX + name)
        else:
            mark = contextlib.nullcontext()
        with mark:
            t = time.perf_counter()
            try:
                yield
            finally:
                self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t


def load_cell(name: str, seed: int, seconds: float, trace: bool, device: str, bench: dict | None = None,
              config: dict | None = None, **overrides) -> Cell:
    """The cell ``name`` of ``bench`` (default: BENCHMARK.json); ``config``
    replaces its configuration's file (tests run small ones)."""
    bench = load_json(ROOT / "BENCHMARK.json") if bench is None else bench
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(entries)})")
    entry = entries[name]
    if config is None:
        files = {c["name"]: c["file"] for c in bench["configs"]}
        config = load_json(ROOT / files[entry["config"]])
    return Cell(
        name=name,
        seed=seed,
        seconds=seconds,
        trace=trace,
        device=device,
        entry=entry,
        config=config,
        traffic=load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        workload=load_json(HERE / "workloads" / f"{name}.json"),
        bench=bench,
        **overrides,
    )


def _metrics_of(cell: Cell, kind: str) -> list:
    return [m for m in cell.bench[kind] if "workloads" not in m or cell.name in m["workloads"]]


def _finite(v: float) -> float:
    return v if math.isfinite(v) else sys.float_info.max


def run_cell(cell: Cell, started: float) -> tuple:
    """Run the cell -> (the result's JSON object, the compared numbers'
    lines for standard error)."""
    import torch

    device = torch.device(cell.device)
    job = load_module(HERE / "jobs" / f"{cell.traffic['job']}.py").Job(cell)
    if cell.trace:
        trace_mod.profile(device.type).stop()  # a process's first profiler start costs seconds
    job.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    counters0 = job.counters()
    gc.collect()

    # the window: a closed loop of one client; with --trace 1 the profiler
    # records its last trace_slice_s seconds (from the first batch that
    # starts in them), so that it stops after the window
    t_start = time.perf_counter()
    setup_s = t_start - started
    deadline = t_start + cell.seconds
    trace_from = deadline - min(cell.traffic.get("trace_slice_s", cell.seconds), cell.seconds)
    prof = None
    requests = []
    gc.disable()  # no collector's pause inside a request
    try:
        while not requests or time.perf_counter() < deadline:
            if cell.trace and prof is None and time.perf_counter() >= trace_from:
                prof = trace_mod.profile(device.type)
            clock = SpanClock(prof is not None)
            with clock("batch"):
                work, passes = job.request(len(requests), clock)
            requests.append(Request(work, passes, clock.seconds, prof is not None))
        window_s = time.perf_counter() - t_start
    finally:
        gc.enable()
    if prof is not None:
        prof.stop()

    for req, ms in zip(requests, job.latencies_ms()):
        req.latency_ms = ms
    counters = {k: v - counters0.get(k, 0) for k, v in job.counters().items()}
    counters["passes"] = sum(r.passes for r in requests)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    sl = trace_mod.read(prof) if prof is not None else None
    job.release()

    # what the window produced against the plain reference
    t_check = time.perf_counter()
    readings = job.check()
    check_s = time.perf_counter() - t_check
    limits = cell.workload["limits"]
    failed = sum(1 for r in readings if not check.passed(check.judge(r, limits)))
    checks = check.judge(check.worst(readings), limits)
    correct = check.passed(checks) and failed == 0

    record = Record(cell, job.device_name, setup_s, window_s, requests, counters, sl, job.extra)
    metrics = {}
    for m in _metrics_of(cell, "per_layer" if cell.trace else "end_to_end"):
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": job.device_name,
        "count": int(cell.entry.get("chips", 1)),
        "memory_peak_bytes": int(memory_peak),
    }
    power = power_limit() if device.type == "cuda" else None
    if power:
        dev["power_limit"] = power
    if sl is not None:
        dev["busy_s"] = sl.busy_s
        dev["window_s"] = sl.window_s
    result = {
        "correct": bool(correct),
        "attempted": len(requests),
        "failed": int(failed),
        "metrics": metrics,
        "device": dev,
    }
    if sl is not None:
        result["breakdown"] = trace_mod.breakdown(sl)
    result["counters"] = counters
    result["checks"] = {k: {"value": _finite(c["value"]), "limit": c["limit"]} for k, c in checks.items()}
    quarters = [requests[len(requests) * q // 4 : len(requests) * (q + 1) // 4] for q in range(4)]
    lines = [
        f"setup {setup_s:.3f} s, window {window_s:.3f} s ({len(requests)} requests), reference {check_s:.3f} s",
        "request ms by quarter of the window: "
        + " ".join(f"{1e3 * sum(r.spans['batch'] for r in q) / max(len(q), 1):.4f}" for q in quarters),
        f"checked batches {sorted(job.checked)} of {len(requests)}; correct: {correct}",
    ]
    lines += [f"check {k}: {c['value']!r} (limit {c['limit']!r})" for k, c in checks.items()]
    return result, lines


def power_limit() -> str | None:
    """The card's name and power limit as nvidia-smi reads them, or None."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 and proc.stdout.strip() else None


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="benchmark/run.py", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True, help="the seed of the run's inputs")
    p.add_argument("--seconds", type=float, required=True, help="the measured window's length")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: a profiled run that reports the per-layer metrics")
    return p


def main(argv, started: float) -> int:
    args = build_argparser().parse_args(argv)
    for var, sub in CACHE_ENV.items():
        os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
    bench = load_json(ROOT / "BENCHMARK.json")
    chips = {w["name"]: int(w.get("chips", 1)) for w in bench["workloads"]}
    if args.workload not in chips:
        print(f"error: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips[args.workload]:
        print(
            f"error: {args.workload} needs {chips[args.workload]} CUDA device(s); PyTorch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
            file=sys.stderr,
        )
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    cell = load_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", bench)
    result, lines = run_cell(cell, started)
    found = forbidden_modules()
    if found:
        print(f"error: modules loaded that the run must not load: {found}", file=sys.stderr)
        return 3
    sys.stderr.write("".join(line + "\n" for line in lines))
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
