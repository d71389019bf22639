"""Run chip_smoke.py's phase 12 inverse loop (engine mega) several times on
one CUDA GPU, for this checkout and for other checkouts, and report how
far each run got: its losses, the sphere's offset and the ground's albedo
error at the start and the end, and the first step whose loss is not
finite. Each checkout also runs its K1, and K3/K4's gradients through
``megakernel_grad.make_diff_renderer``, twice on the same inputs and says
whether the two results are equal bit for bit.

    python3 tools/torch_inverse_repeat.py [--runs N] [--engine mega|mega-fwd] [OTHER_ROOT ...]

An OTHER_ROOT is the root of another checkout (for example a parent commit
unpacked with ``git archive``). Every checkout runs in a process of its
own, with its root first on ``sys.path``, so it builds and runs its own
kernels. The loop is ``kajo_tpu_torch.inverse_rendering.main`` at
chip_smoke.py's size (``build_test_scene`` 128x96, 16 spp, depth 4, 100
steps). The last line is a JSON summary; the exit code is 1 if a run of
any checkout failed chip_smoke.py's phase 12 test (a loss not finite, the
offset not smaller at the end, or for engine mega the albedo error not
smaller).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
W, H, SPP, DEPTH, STEPS = 128, 96, 16, 4, 100  # chip_smoke.py's INV_*


def repeat_bits(dev) -> dict:
    """K1's image and K3/K4's gradients of one fixed cotangent, each computed
    twice on the same inputs -> {name: equal bit for bit}."""
    import torch

    from kajo_tpu_torch.diff.inverse import apply_params, extract_params
    from kajo_tpu_torch.models.integrator import RenderConfig
    from kajo_tpu_torch.ops import megakernel, megakernel_grad
    from kajo_tpu_torch.scene.testscene import build_test_scene

    config = RenderConfig(max_depth=DEPTH)
    scene = build_test_scene(W / H, dev)
    g = torch.rand((H, W, 3), generator=torch.Generator().manual_seed(0)).to(dev)
    render = megakernel_grad.make_diff_renderer(W, H, SPP, config, geometry=True)

    def grads():
        leaves = {k: v.requires_grad_(True) for k, v in extract_params(scene, ("sphere_transform", "diffuse")).items()}
        with torch.enable_grad():
            img = render(apply_params(scene, leaves), 11)
            out = torch.autograd.grad((img[..., :3] * g).sum(), list(leaves.values()))
        return dict(zip(leaves, out))

    def bits(x):
        return x.contiguous().view(torch.int32)

    k1 = [megakernel.render_pass_megakernel(scene, 11, W, H, SPP, config) for _ in range(2)]
    ga, gb = grads(), grads()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    res = {"K1 image": bool(torch.equal(bits(k1[0]), bits(k1[1])))}
    for k in ga:
        res[f"gradient of {k}"] = bool(torch.equal(bits(ga[k]), bits(gb[k])))
        res[f"gradient of {k}, max |a - b|"] = float((ga[k] - gb[k]).abs().max())
    return res


def child(root: str, runs: int, engine: str) -> int:
    sys.path.insert(0, root)
    sys.stdout.reconfigure(line_buffering=True)
    import numpy as np
    import torch

    from kajo_tpu_torch import inverse_rendering

    if not torch.cuda.is_available():
        print("error: needs a CUDA device", file=sys.stderr)
        return 1
    out = {"root": root, "repeat_bits": repeat_bits(torch.device("cuda")), "runs": []}
    print(f"{root}: same inputs twice, equal bits: {out['repeat_bits']}")
    with tempfile.TemporaryDirectory(dir=Path(root) / "build") as tmp:
        for i in range(runs):
            summary = Path(tmp) / "summary.json"
            rc = inverse_rendering.main(["--engine", engine, "-w", str(W), "-h", str(H), "--spp", str(SPP),
                                         "--depth", str(DEPTH), "--steps", str(STEPS), "--print-every",
                                         str(STEPS), "--out-prefix", str(Path(tmp) / "inv"), "--summary",
                                         str(summary)])
            rec = json.loads(summary.read_text())
            losses = np.asarray(rec["losses"])
            bad = np.flatnonzero(~np.isfinite(losses))
            ok = (rc == 0 and not len(bad) and rec["offset"][1] < rec["offset"][0]
                  and (engine != "mega" or rec["albedo_error"][1] < rec["albedo_error"][0]))
            run = dict(run=i, rc=rc, ok=bool(ok), first_nonfinite_step=int(bad[0]) if len(bad) else None,
                       loss=[float(losses[0]), float(losses[9]), float(losses[49]), float(losses[-1])],
                       offset=rec["offset"], albedo_error=rec["albedo_error"],
                       drift={k: [round(x, 4) for x in v] for k, v in rec["drift"].items()})
            out["runs"].append(run)
            print(f"{root} run {i}: {json.dumps(run)}")
    print("CHILD " + json.dumps(out))
    return 0


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=8)
    ap.add_argument("--engine", default="mega", choices=["mega", "mega-fwd"])
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("roots", nargs="*")
    args = ap.parse_args(argv)
    if args.child:
        return child(args.child, args.runs, args.engine)
    results = []
    for root in [str(ROOT)] + [str(Path(r).resolve()) for r in args.roots]:
        (Path(root) / "build").mkdir(exist_ok=True)
        proc = subprocess.run([sys.executable, __file__, "--child", root, "--runs", str(args.runs), "--engine",
                               args.engine], capture_output=True, text=True)
        lines = proc.stdout.splitlines()
        for ln in lines:
            if not ln.startswith("CHILD "):
                print(ln)
        if proc.returncode != 0:
            print(proc.stderr[-4000:])
        rec = next((json.loads(ln[6:]) for ln in lines if ln.startswith("CHILD ")), {"root": root, "runs": []})
        rec["rc"] = proc.returncode
        results.append(rec)
        n_ok = sum(r["ok"] for r in rec["runs"])
        print(f"{root}: rc={proc.returncode}, {n_ok} of {len(rec['runs'])} runs pass phase 12's test")
    print(json.dumps({"inverse_repeat": [{"root": r["root"], "rc": r["rc"],
                                          "passed": sum(x["ok"] for x in r["runs"]), "runs": len(r["runs"]),
                                          "repeat_bits": r.get("repeat_bits")} for r in results]}))
    return 0 if all(r["rc"] == 0 and all(x["ok"] for x in r["runs"]) and r["runs"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
