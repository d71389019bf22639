"""Does kajo_tpu's own engine ``jax`` fit drift as the port's does?

    JAX_PLATFORMS=cpu python tools/torch_drift_witness.py [--steps 10] [--seeds 7,11,13] [--json out.json]

The inverse-rendering configuration of ``kajo_tpu_torch/inverse_rendering.py``
(``build_test_scene``; the red sphere moved by (+0.2, 0, -0.1), the ground's
albedo set to (0.2, 0.1, 0.3); ``sphere_transform`` and ``diffuse``
optimised by Adam at 2e-2, cosine-decayed over the run, ``loss_clip`` 1.0,
no boundary term), cut to a size the CPU takes: 32x24, 4 spp, depth 4.

Both packages fit from the same target (the port's plain K1 at 64 spp, seed
123, handed to kajo_tpu as an array) with engine ``jax``, the differentiable
budget engine. Step i of seed s draws ``fold_in(PRNGKey(s), i)``: kajo_tpu's
step splits it into its two render keys, and the port's step takes the u32
``seed_from_key`` of each, which is what kajo_tpu's budget pass makes of
them, so both render the same paths. Per step it prints each package's loss
and the sphere's offset from its true position. Runs on the CPU; kajo_tpu's
step is one ``jax.jit`` compilation (a minute or so).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kajo_tpu.diff.inverse import InverseRenderer as JaxInverseRenderer  # noqa: E402
from kajo_tpu.models.integrator import RenderConfig as JaxRenderConfig  # noqa: E402
from kajo_tpu.ops.rng import seed_from_key  # noqa: E402
from kajo_tpu.scene.testscene import build_test_scene as jax_build_test_scene  # noqa: E402
from kajo_tpu_torch.diff.inverse import InverseRenderer, apply_params  # noqa: E402
from kajo_tpu_torch.inverse_rendering import GROUND, GROUND_ALBEDO, SHIFT, SPHERE  # noqa: E402
from kajo_tpu_torch.models.integrator import RenderConfig  # noqa: E402
from kajo_tpu_torch.ops.megakernel import render_pass_megakernel  # noqa: E402
from kajo_tpu_torch.scene.testscene import build_test_scene  # noqa: E402

W, H, SPP, DEPTH, TARGET_SPP = 32, 24, 4, 4, 64
PARAMS = ("sphere_transform", "diffuse")


def fit_pair(seed: int, steps: int, target: np.ndarray) -> dict:
    """Both packages' fits on one seed -> {"jax"|"port": {"loss", "offset"}}."""
    truth = build_test_scene(W / H, "cpu")
    st = truth.sphere_transform.clone()
    for r, c, delta in SHIFT:
        st[SPHERE, r, c] += delta
    diffuse = truth.materials.diffuse.clone()
    diffuse[GROUND, :3] = torch.tensor(GROUND_ALBEDO)
    wrong = apply_params(truth, {"sphere_transform": st, "diffuse": diffuse})
    true_c = truth.sphere_transform[SPHERE, :3, 3].numpy()

    jtruth = jax_build_test_scene(W / H)
    jwrong = dataclasses.replace(
        jax.tree.map(jnp.asarray, jtruth),
        sphere_transform=jnp.asarray(st.numpy()),
        materials=dataclasses.replace(jtruth.materials, diffuse=jnp.asarray(diffuse.numpy())),
    )
    np.testing.assert_array_equal(np.asarray(jtruth.sphere_transform), truth.sphere_transform.numpy())

    kw = dict(spp=SPP, learning_rate=2e-2, loss_clip=1.0, decay_steps=steps, engine="jax", param_spec=PARAMS)
    port = InverseRenderer(wrong, torch.from_numpy(target), W, H, config=RenderConfig(max_depth=DEPTH), **kw)
    ref = JaxInverseRenderer(jwrong, jnp.asarray(target), W, H, config=JaxRenderConfig(max_depth=DEPTH), **kw)

    def offset(st_now):
        return float(np.linalg.norm(np.asarray(st_now)[SPHERE, :3, 3] - true_c))

    out = {"jax": {"loss": [], "offset": [offset(st)]}, "port": {"loss": [], "offset": [offset(st)]}}
    for i in range(steps):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), i)
        k1, k2 = jax.random.split(key)
        out["jax"]["loss"].append(ref.step(key))
        out["jax"]["offset"].append(offset(ref.params["sphere_transform"]))
        out["port"]["loss"].append(port.step(int(seed_from_key(k1)), int(seed_from_key(k2))))
        out["port"]["offset"].append(offset(port.params["sphere_transform"].detach()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seeds", default="7,11,13")
    ap.add_argument("--json", default=None, help="write every curve here")
    args = ap.parse_args(argv)
    torch.set_num_threads(min(8, os.cpu_count() or 1))

    truth = build_test_scene(W / H, "cpu")
    target = render_pass_megakernel(truth, 123, W, H, TARGET_SPP, RenderConfig(max_depth=DEPTH)).numpy()
    print(f"build_test_scene {W}x{H}, {SPP} spp, depth {DEPTH}, {args.steps} Adam steps, engine jax, "
          f"target: the port's plain K1 at {TARGET_SPP} spp")
    curves = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        run = curves[seed] = fit_pair(seed, args.steps, target)
        print(f"seed {seed} ({time.time() - t0:.1f} s)")
        print("  step  loss kajo_tpu  loss port    offset kajo_tpu  offset port")
        for i in range(args.steps + 1):
            loss = (f"{run['jax']['loss'][i - 1]:.6f}   {run['port']['loss'][i - 1]:.6f}" if i
                    else "        -          -")
            print(f"  {i:4d}  {loss}   {run['jax']['offset'][i]:.4f}           {run['port']['offset'][i]:.4f}")
        j, p = run["jax"]["loss"], run["port"]["loss"]
        print(f"  loss first -> last: kajo_tpu {j[0]:.6f} -> {j[-1]:.6f} (x{j[-1] / j[0]:.2f}), "
              f"port {p[0]:.6f} -> {p[-1]:.6f} (x{p[-1] / p[0]:.2f})")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({str(k): v for k, v in curves.items()}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
