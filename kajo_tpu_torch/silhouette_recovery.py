"""Silhouette-only inverse rendering, port of ``examples/silhouette_recovery.py``.

    python -m kajo_tpu_torch.silhouette_recovery [--steps 60]
    python -m kajo_tpu_torch.silhouette_recovery --device cpu --steps 4

The probe scene is the hard case for interior gradients: a self-luminous
(flat-lit) sphere on a uniform background. Its radiance carries no shading
gradient, so the only signal for its position is the silhouette sweeping
across pixels, which K4's interior gradients cannot see. The boundary term
of ``diff/edges.py`` samples the sphere's silhouette circle and recovers the
position anyway.

The sphere starts at (0.7, -0.45) and its truth is the origin; the target
and the start are rendered by the parity engine (``render_image``, 16 spp,
2 passes, keys 7 and 8). ``InverseRenderer`` fits the sphere's transform on
engine ``mega`` (K1 forward, K3 and K4 backward) with ``edge_gradients``,
``n_edge`` 512 and learning rate 5e-2, at 64x64, 16 spp, ``max_depth`` 2, as
the JAX example does. Every 10 steps it prints the loss and the position error
|(cx, cy)|; it writes the target, start and recovered PNGs
(``--out-prefix``) and, with ``--summary``, a JSON record: the error at
each printed step, the losses and the time per step (CUDA events on a GPU,
else the host clock). It runs on ``--device`` (``cuda`` by default; without
a GPU it exits non-zero unless given ``--device cpu``, which runs the plain
PyTorch versions).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np

START = (0.7, -0.45)
BACKGROUND = (0.25, 0.3, 0.4, 1.0)
SIZE = 64  # image width and height
SPP = 16  # samples per pixel of the fit's renders
N_EDGE = 512  # silhouette samples per sphere and step
SEED = 9  # u32 seed of the steps' render seeds and edge keys


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="kajo-torch-silhouette", description=__doc__.split("\n\n")[0], add_help=False)
    p.add_argument("--help", action="help", help="show this help")
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out-prefix", default="silhouette")
    p.add_argument("--summary", default=None, help="write a JSON record of the run here")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    import torch

    from .diff.inverse import InverseRenderer
    from .models.integrator import RenderConfig, render_image
    from .scene.testscene import build_silhouette_scene
    from .utils.image import save_png

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"error: --device {args.device} but PyTorch sees no CUDA device; pass --device cpu", file=sys.stderr)
        return 2
    w = h = SIZE
    cfg = RenderConfig(max_depth=2)

    target = render_image(build_silhouette_scene(0.0, 0.0, BACKGROUND, device), w, h, 16, 7, passes=2, config=cfg)
    save_png(f"{args.out_prefix}_target.png", target.cpu().numpy())
    start = build_silhouette_scene(*START, BACKGROUND, device)
    save_png(f"{args.out_prefix}_start.png", render_image(start, w, h, 16, 8, passes=2, config=cfg).cpu().numpy())

    inv = InverseRenderer(
        start, target, w, h, spp=SPP, config=cfg, param_spec=("sphere_transform",), edge_gradients=True,
        n_edge=N_EDGE, learning_rate=5e-2, engine="mega", seed=SEED,
    )

    def error() -> float:
        st = inv.params["sphere_transform"].detach()
        return math.hypot(float(st[0, 0, 3]), float(st[0, 1, 3]))

    err0 = error()
    print(f"engine {inv.engine} on {device}: {w}x{h} {SPP} spp, n_edge {N_EDGE}, {args.steps} steps; "
          f"start position error {err0:.4f}")
    losses, errors = [], [(0, err0)]
    cuda = device.type == "cuda"
    if cuda:
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        ev0.record()
    t0 = time.perf_counter()
    for i in range(args.steps):
        losses.append(inv.step())
        if (i + 1) % 10 == 0 or i + 1 == args.steps:
            errors.append((i + 1, error()))
            print(f"step {i + 1:3d}  loss {losses[-1]:.5f}  |pos err| {errors[-1][1]:.4f}")
    if cuda:
        ev1.record()
        torch.cuda.synchronize()
        loop_ms = ev0.elapsed_time(ev1)
    else:
        loop_ms = (time.perf_counter() - t0) * 1e3
    ms_per_step = loop_ms / max(args.steps, 1)

    recovered = inv.current_scene()
    save_png(f"{args.out_prefix}_recovered.png",
             render_image(recovered, w, h, 16, 10, passes=2, config=cfg).cpu().numpy())
    st = inv.params["sphere_transform"].detach()
    print(f"recovered center: ({float(st[0, 0, 3]):.4f}, {float(st[0, 1, 3]):.4f}), truth (0, 0); "
          f"{ms_per_step:.2f} ms per step ({'CUDA events' if cuda else 'host clock'})")
    if args.summary:
        with open(args.summary, "w") as f:
            json.dump(dict(engine=inv.engine, steps=args.steps, size=w, spp=SPP, n_edge=N_EDGE,
                           losses=losses, errors=errors, ms_per_step=ms_per_step, device=str(device)), f)
    return 0 if np.isfinite(losses).all() else 1


if __name__ == "__main__":
    sys.exit(main())
