"""The readings that set a cell's correctness limits: for each seed, the
comparison's numbers (``benchmark/check.py``) of

- the program: a batch through the engine's batch entry, as the window
  renders it (the lower reading's side; full runs give the rest);
- the control: the plain reference computed in bfloat16, the precision
  below the configuration's float32, in the program's place;
- each planted fault (``benchmark/tools/faults.py``): a batch that leaves
  the sum unchanged, a stale batch, half a batch scaled up, one lane's sums
  doubled where K1 produces them.

Each is judged as the window's first batch is: against the float32
reference's image of the same passes, from a zero sum.

    python3 benchmark/tools/control.py --workload caustics.progressive --seeds 11 12 13

prints one JSON line per seed and the smallest control and fault readings.
On the card at the cell's own size it takes a few seconds a seed; the
tests run it on the CPU at a small size.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def readings(cell, seed: int, batch_index: int = 1) -> dict:
    """{side: {number: reading}} of one seed at the cell's size, batch
    ``batch_index`` (judged from a zero sum; the stale fault repeats batch
    ``batch_index - 1``)."""
    import torch

    from benchmark.check import gaps
    from benchmark.harness import HERE, load_json, resolve
    from benchmark.reference import scene as ref_scene
    from benchmark.reference import walk
    from benchmark.tools import faults
    from kajo_tpu_torch.models.engine import select_engine
    from kajo_tpu_torch.models.integrator import RenderConfig
    from kajo_tpu_torch.scene import parser

    cfg = cell.config
    w, h, spp = int(cfg["width"]), int(cfg["height"]), int(cfg["spp"])
    n = int(cell.traffic["batch_passes"])
    estimator = {"max_depth": int(cfg["max_depth"]), **cfg["estimator"]}
    path = HERE / cfg["scene"]
    device = torch.device(cell.device)
    scene = parser.load(str(path), w / h, device)
    engine = select_engine(scene, cell.engine or cell.workload["engine"])
    entry = resolve(load_json(HERE / "engines" / f"{engine}.json")["entry"])
    config = RenderConfig(**estimator)
    first = batch_index * n

    def run(fn):
        return fn(scene, seed, first, w, h, spp, n, config).cpu().numpy()

    images = {"program": run(entry)}
    for name, wrap in faults.WRAPS.items():
        broken = wrap(entry)
        if name == "stale":
            broken(scene, seed, first - n, w, h, spp, n, config)
        images[f"fault_{name}"] = run(broken)
    rs = ref_scene.load_packed(path, w / h, device)
    est = walk.Estimator(**estimator)
    ref = walk.batch_image(rs, seed, first, n, w, h, spp, est).cpu().numpy()
    # the altered lane: the brightest pixel of the reference's image, so
    # that the fault is an answer that matters
    lane = int(np.argmax(ref[..., :3].sum(-1)))
    with faults.altered_lane(lane):
        images["fault_lane"] = run(entry)
    images["control_bf16"] = walk.batch_image(rs, seed, first, n, w, h, spp, est, torch.bfloat16).cpu().numpy()
    zero = np.zeros_like(ref)
    return {side: gaps(img, zero, ref) for side, img in images.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)

    import torch

    from benchmark.harness import load_cell

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = load_cell(args.workload, 0, 0.0, False, "cuda")
    lowest = {}
    for seed in args.seeds:
        r = readings(cell, seed)
        print(json.dumps({"workload": args.workload, "seed": seed, **r}), flush=True)
        for side, nums in r.items():
            for k, v in nums.items():
                lowest.setdefault(side, {}).setdefault(k, v)
                lowest[side][k] = min(lowest[side][k], v) if side != "program" else max(lowest[side][k], v)
    print(json.dumps({"workload": args.workload, "seeds": args.seeds, "program_max_else_min": lowest}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main())
