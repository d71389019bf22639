"""The traced slice of a ``--trace 1`` run: ``torch.profiler`` over the
window's last batches, the CPU and the card, with the harness's spans as
``bench.<name>`` annotations, read back from its Chrome trace.

The slice runs from the start of its first ``bench.batch`` span to the end
of its last. The card is busy where a kernel, a copy or a memset runs on
it; an idle stretch is labelled by the innermost harness span the host was
in then.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import shutil
import tempfile

from .stats import gaps, union_length

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "bench."
NAME_CHARS = 120  # kernel names are long templated signatures


@dataclasses.dataclass
class Slice:
    """What the traced slice shows, in seconds."""

    window_s: float
    busy_s: float
    device_s: dict  # name -> seconds of the card's operations of that name
    idle_s: dict  # label of what the host was doing -> idle seconds of the card
    idle_count: dict  # label -> idle stretches


def profile(device_type: str):
    """A started profiler of the CPU, and of the card on a CUDA device."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device_type == "cuda" else [])
    prof = torch_profile(activities=activities, acc_events=True)
    prof.start()
    return prof


def read(prof) -> Slice | None:
    """The slice of the stopped profiler ``prof``: its Chrome trace is
    written under TMPDIR, read and deleted; None where it holds no batch."""
    folder = tempfile.mkdtemp(prefix="bench_trace_")
    try:
        path = os.path.join(folder, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    return summarise(events)


def summarise(events: list) -> Slice | None:
    """Chrome trace events (``ts`` and ``dur`` in microseconds) -> Slice."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    spans = [
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"][len(PREFIX):])
        for e in xs
        if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith(PREFIX)
    ]
    batches = [s for s in spans if s[2] == "batch"]
    if not batches:
        return None
    lo, hi = min(s[0] for s in batches), max(s[1] for s in batches)
    device = [e for e in xs if e.get("cat") in DEVICE_CATS]
    intervals = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device]
    device_s = {}
    for e in device:
        s, t = max(float(e["ts"]), lo), min(float(e["ts"]) + float(e["dur"]), hi)
        if t > s:
            name = str(e["name"])[:NAME_CHARS]
            device_s[name] = device_s.get(name, 0.0) + (t - s) / 1e6
    idle_s, idle_count = {}, {}
    segments = host_segments(spans, lo, hi)
    j = 0
    for s, t in gaps(intervals, lo, hi):  # both sorted: one sweep
        while segments[j][1] <= s:
            j += 1
        for a, b, label in segments[j:]:
            if a >= t:
                break
            idle_s[label] = idle_s.get(label, 0.0) + (min(b, t) - max(a, s)) / 1e6
            idle_count[label] = idle_count.get(label, 0) + 1
    return Slice(
        window_s=(hi - lo) / 1e6,
        busy_s=union_length(intervals, lo, hi) / 1e6,
        device_s=device_s,
        idle_s=idle_s,
        idle_count=idle_count,
    )


def host_segments(spans: list, lo: float, hi: float) -> list:
    """[lo, hi] cut into (start, end, label) pieces, each labelled by the
    innermost span around it ("between batches" outside every span).
    Spans nest (a batch holds its parts) and do not otherwise overlap."""
    spans = sorted(spans)
    starts = [sp[0] for sp in spans]
    cuts = sorted({lo, hi, *(x for sp in spans for x in sp[:2] if lo < x < hi)})
    out = []
    for a, b in zip(cuts, cuts[1:]):
        mid = 0.5 * (a + b)
        k = bisect.bisect_right(starts, mid)
        around = [sp for sp in spans[max(k - 8, 0) : k] if mid <= sp[1]]
        label = min(around, key=lambda sp: sp[1] - sp[0])[2] if around else "between batches"
        if out and out[-1][2] == label and out[-1][1] == a:
            out[-1] = (out[-1][0], b, label)
        else:
            out.append((a, b, label))
    return out


def breakdown(sl: Slice, top: int = 10) -> dict:
    """The costliest device operations and the idle time by what the host was
    doing, at most ``top`` of each, in seconds."""
    ops = sorted(sl.device_s.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(sl.idle_s.items(), key=lambda kv: -kv[1])[:top]
    return {
        "device_ops": [[name, s] for name, s in ops],
        "idle_gaps": [[f"host in {label} ({sl.idle_count[label]} gaps)", s] for label, s in idle],
    }
