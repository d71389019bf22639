"""The readings that set the field cell's correctness limits
(``procedural100k.progressive8``): for each seed, the comparison's numbers
(``benchmark/check.py``) over the screen tiles the job checks in batch
``batch_index``, of

- the program: the batch through the engine's batch entry, as the window
  renders it (the lower reading's side; full runs give the rest);
- the control: the plain reference (``benchmark/reference/field.py``)
  computed in bfloat16, the precision below the configuration's float32,
  in the program's place;
- each planted fault: a zero image, a stale batch, half the passes scaled
  by two (``benchmark/tools/faults.py``), and one lane's sums doubled where
  the wavefront produces them (the lane of a checked pixel that sums the
  most light in the batch's first pass).

Each is judged as the window's first batch is: against the float32
reference's pixels of the same passes, from a zero sum.

    python3 benchmark/tools/control_field.py --seeds 11 12 13

prints one JSON line per seed (with the seconds the reference took) and
the largest program reading and the smallest control and fault readings.
The tests run it on the CPU at a small size.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

CELL = "procedural100k.progressive8"


@contextlib.contextmanager
def altered_lane(lane: int, factor: float = 2.0):
    """The wavefront's radiance sums of ``lane`` multiplied by ``factor``
    in every pass, where the loop returns them."""
    from kajo_tpu_torch.models import wavefront

    original = wavefront.render_lanes

    def broken(*args, **kwargs):
        rgb, iters, rays = original(*args, **kwargs)
        rgb = rgb.clone()
        rgb[lane] *= factor
        return rgb, iters, rays

    wavefront.render_lanes = broken
    try:
        yield
    finally:
        wavefront.render_lanes = original


def lane_sums(job, first_pass: int):
    """The wavefront's summed RGB of every lane of pass ``first_pass``
    through the job's engine -> [lanes] (a numpy array)."""
    from kajo_tpu_torch.models import wavefront

    original, kept = wavefront.render_lanes, []

    def keep(*args, **kwargs):
        out = original(*args, **kwargs)
        kept.append(out[0].sum(-1).cpu().numpy())
        return out

    wavefront.render_lanes = keep
    try:
        job.entry(job.scene, job.seed, first_pass, job.width, job.height, job.spp, 1, job.config)
    finally:
        wavefront.render_lanes = original
    return kept[0]


def brightest_lane(job, first_pass: int, base_lanes) -> int:
    """The lane, among those of the first-sample lanes ``base_lanes`` (each
    pixel's lanes are l + k W H), that sums the most light in pass
    ``first_pass``."""
    sums = lane_sums(job, first_pass)
    n = job.width * job.height
    mine = np.isin(np.arange(sums.shape[0]) % n, np.asarray(base_lanes))
    return int(np.flatnonzero(mine)[np.argmax(sums[mine])])


def readings(cell, seed: int, batch_index: int = 1) -> dict:
    """{side: {number: reading}} of one seed at the cell's size, batch
    ``batch_index`` on its checked tiles (judged from a zero sum; the stale
    fault repeats batch ``batch_index - 1``), and "seconds": the float32
    reference's time."""
    import torch

    from benchmark.check import gaps
    from benchmark.harness import HERE, load_module
    from benchmark.reference import field
    from benchmark.tools import faults

    cell.seed = seed
    job = load_module(HERE / "jobs" / f"{cell.traffic['job']}.py").Job(cell)
    saved = cell.traffic
    cell.traffic = dict(saved, warmup_s=0.0)
    try:
        job.setup()
    finally:
        cell.traffic = saved
    w, h, n = job.width, job.height, job.batch
    first = batch_index * n
    px = field.tile_pixels(w, h, job.tiles_of(batch_index))
    lanes = field.pixel_lanes(w, h, px)

    def run(fn):
        return fn(job.scene, seed, first, w, h, job.spp, n, job.config).cpu().numpy().reshape(-1, 4)[px]

    images = {"program": run(job.entry)}
    for name, wrap in faults.WRAPS.items():
        broken = wrap(job.entry)
        if name == "stale":
            broken(job.scene, seed, first - n, w, h, job.spp, n, job.config)
        images[f"fault_{name}"] = run(broken)
    est = field.Estimator(**job.estimator)
    if job.cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = field.render_batch(job.reference_field(), seed, first, n, w, h, job.spp, est, lanes).cpu().numpy()
    seconds = time.perf_counter() - t0
    with altered_lane(brightest_lane(job, first, lanes)):
        images["fault_lane"] = run(job.entry)
    images["control_bf16"] = field.render_batch(job.reference_field(torch.bfloat16), seed, first, n, w, h, job.spp,
                                                est, lanes).cpu().numpy()
    zero = np.zeros_like(ref)
    out = {side: gaps(img, zero, ref) for side, img in images.items()}
    out["seconds"] = seconds
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)

    import torch

    from benchmark.harness import load_cell

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = load_cell(CELL, 0, 0.0, False, "cuda")
    lowest = {}
    for seed in args.seeds:
        r = readings(cell, seed)
        print(json.dumps({"workload": CELL, "seed": seed, **r}), flush=True)
        for side, nums in r.items():
            if side == "seconds":
                continue
            for k, v in nums.items():
                lowest.setdefault(side, {}).setdefault(k, v)
                lowest[side][k] = min(lowest[side][k], v) if side != "program" else max(lowest[side][k], v)
    print(json.dumps({"workload": CELL, "seeds": args.seeds, "program_max_else_min": lowest}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main())
