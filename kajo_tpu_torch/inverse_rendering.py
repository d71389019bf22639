"""Inverse rendering demo (BASELINE.md config 4), port of
``examples/inverse_rendering.py``.

    python -m kajo_tpu_torch.inverse_rendering [--steps 100] [--engine mega|mega-fwd|jax]
    python -m kajo_tpu_torch.inverse_rendering --device cpu -w 16 -h 12 --spp 4 --steps 4

Perturbs the CLI's built-in scene (``build_test_scene``): the red Phong
sphere moves by (+0.2, 0, -0.1) and the ground's albedo becomes (0.2, 0.1,
0.3); then recovers them from a target render with ``InverseRenderer``:
``loss_clip=1.0``, learning rate 2e-2 cosine-decayed over the run, at
128x96, 16 spp, ``max_depth=4`` by default. The target is a K1 render of the
true scene at 64 spp (the JAX example's parity ``render_pass`` is not
ported). Engine ``mega`` optimises every sphere's transform and every
albedo (K1 forward, K3 and K4 backward), or the tensors ``--params`` names;
engine ``jax`` the same tensors through the differentiable budget engine
(``render_pass_budget`` under autograd; any scene tensor may be named);
``mega-fwd`` the three scalars of the sphere's translation (K2, one pass per
scalar and render). ``--edge-gradients`` adds the silhouette boundary term
of ``diff/edges.py`` to engine ``mega``'s or ``jax``'s renders.

Every ``--print-every`` steps it prints the loss, the sphere's offset from
its true position and the ground's albedo error, and at the end how far
each object's optimised entries moved; it writes the target, start and
recovered PNGs (``--out-prefix``) and, with ``--summary``, a JSON record of
the run: every loss, the offsets and errors at the start and the end, the
moves, the optimised tensors at the end, and the time per step (CUDA
events on a GPU, else the host clock).
It runs on ``--device`` (``cuda`` by default; without a GPU it exits non-zero unless
given ``--device cpu``, which runs the plain PyTorch versions).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

SPHERE = 1  # the red Phong sphere of build_test_scene
GROUND = 0  # the ground plane's material
SHIFT = ((0, 3, 0.2), (2, 3, -0.1))  # (row, col, delta) of sphere_transform[SPHERE]
GROUND_ALBEDO = (0.2, 0.1, 0.3)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="kajo-torch-inverse", description=__doc__.split("\n\n")[0], add_help=False)
    p.add_argument("--help", action="help", help="show this help")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--engine", default="mega", choices=["mega", "mega-fwd", "jax"])
    p.add_argument("--params", default="sphere_transform,diffuse",
                   help="engines mega and jax: the scene tensors to optimise, comma-separated")
    p.add_argument("-w", dest="width", type=int, default=128)
    p.add_argument("-h", dest="height", type=int, default=96)
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("--target-spp", type=int, default=64)
    p.add_argument("--seed", type=int, default=7, help="u32 seed of the steps' render seeds")
    p.add_argument("--edge-gradients", action="store_true",
                   help="engines mega and jax: add the silhouette boundary term to the gradients")
    p.add_argument("--device", default="cuda")
    p.add_argument("--print-every", type=int, default=20)
    p.add_argument("--out-prefix", default="inverse")
    p.add_argument("--summary", default=None, help="write a JSON record of the run here")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    import torch

    from .diff.inverse import InverseRenderer
    from .models.integrator import RenderConfig
    from .ops.megakernel import render_pass_megakernel
    from .scene.testscene import build_test_scene
    from .utils.image import save_png

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"error: --device {args.device} but PyTorch sees no CUDA device; pass --device cpu", file=sys.stderr)
        return 2
    w, h, spp = args.width, args.height, args.spp
    config = RenderConfig(max_depth=args.depth)
    truth = build_test_scene(4.0 / 3.0, device)
    target = render_pass_megakernel(truth, 123, w, h, args.target_spp, config)
    save_png(f"{args.out_prefix}_target.png", target.cpu().numpy())

    st = truth.sphere_transform.clone()
    for r, c, delta in SHIFT:
        st[SPHERE, r, c] += delta
    diffuse = truth.materials.diffuse.clone()
    diffuse[GROUND, :3] = torch.tensor(GROUND_ALBEDO)
    from .diff.inverse import apply_params

    wrong = apply_params(truth, {"sphere_transform": st, "diffuse": diffuse})
    save_png(f"{args.out_prefix}_start.png", render_pass_megakernel(wrong, 9, w, h, spp, config).cpu().numpy())

    if args.engine != "mega-fwd":
        kw = dict(param_spec=tuple(args.params.split(",")))
    else:
        mask = torch.zeros(st.shape, dtype=torch.bool)
        mask[SPHERE, :3, 3] = True
        kw = dict(param_spec=("sphere_transform",), param_mask={"sphere_transform": mask})
    inv = InverseRenderer(
        wrong, target, w, h, spp=spp, config=config, learning_rate=2e-2, loss_clip=1.0,
        decay_steps=args.steps, engine=args.engine, seed=args.seed, edge_gradients=args.edge_gradients, **kw,
    )

    true_c = truth.sphere_transform[SPHERE, :3, 3]
    true_albedo = truth.materials.diffuse[GROUND, :3]

    def errors():
        s = inv.current_scene()
        offset = float(torch.linalg.norm(s.sphere_transform[SPHERE, :3, 3] - true_c))
        albedo = float((s.materials.diffuse[GROUND, :3] - true_albedo).abs().max())
        return offset, albedo

    def drift():
        """Per optimised tensor, how far each object's entry moved from the
        start: the largest change of its row."""
        return {k: (v.detach() - start[k]).reshape(v.shape[0], -1).abs().amax(1).tolist()
                for k, v in inv.params.items()}

    start = {k: v.detach().clone() for k, v in inv.params.items()}
    offset0, albedo0 = errors()
    print(f"engine {args.engine} on {device}: {w}x{h} {spp} spp depth {args.depth}, {args.steps} steps, "
          f"optimising {', '.join(inv.params)}; start: sphere offset {offset0:.4f}, ground albedo error {albedo0:.4f}")
    losses = []
    cuda = device.type == "cuda"
    if cuda:
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        ev0.record()
    t0 = time.perf_counter()
    for i in range(args.steps):
        losses.append(inv.step())
        if (i + 1) % args.print_every == 0 or i + 1 == args.steps:
            offset, albedo = errors()
            print(f"step {i + 1:4d}  loss {losses[-1]:.6f}  sphere offset {offset:.4f}  "
                  f"ground albedo error {albedo:.4f}")
    if cuda:
        ev1.record()
        torch.cuda.synchronize()
        loop_ms = ev0.elapsed_time(ev1)
    else:
        loop_ms = (time.perf_counter() - t0) * 1e3
    offset1, albedo1 = errors()
    ms_per_step = loop_ms / max(args.steps, 1)
    print(f"end: sphere offset {offset0:.4f} -> {offset1:.4f}, ground albedo error {albedo0:.4f} -> {albedo1:.4f}; "
          f"{ms_per_step:.2f} ms per step ({'CUDA events' if cuda else 'host clock'})")
    moved = drift()
    for k, rows in moved.items():
        print(f"drift of {k} per object: " + " ".join(f"{x:.4f}" for x in rows))
    save_png(f"{args.out_prefix}_recovered.png",
             render_pass_megakernel(inv.current_scene(), 9, w, h, spp, config).cpu().numpy())
    if args.summary:
        with open(args.summary, "w") as f:
            json.dump(dict(engine=args.engine, edge_gradients=args.edge_gradients, params=list(inv.params),
                           steps=args.steps, losses=losses,
                           offset=[offset0, offset1], albedo_error=[albedo0, albedo1], drift=moved,
                           tensors={k: v.detach().cpu().tolist() for k, v in inv.params.items()},
                           ms_per_step=ms_per_step, device=str(device)), f)
    return 0 if np.isfinite(losses).all() else 1


if __name__ == "__main__":
    sys.exit(main())
