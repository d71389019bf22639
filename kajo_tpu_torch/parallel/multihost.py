"""Rendering across processes, port of ``kajo_tpu/parallel/multihost.py``.

kajo_tpu joins the hosts of a slice with ``jax.distributed.initialize`` and
runs its SPMD render on every chip of every host. Here each process is one
rank of a ``torch.distributed`` process group, usually one per card, started
by ``torchrun``; the sharded render of ``parallel/render.py`` runs on every
rank, and rank 0 keeps the image.

    torchrun --nproc_per_node 2 -m kajo_tpu_torch.parallel.multihost SCENE.json --out out.png
    torchrun --nproc_per_node 2 -m kajo_tpu_torch.parallel.multihost SCENE.json --device cpu

A single process is a group of one (:func:`ensure_group`). The group takes
PyTorch's default backends: NCCL for CUDA tensors and gloo for CPU ones.
NCCL takes one rank a card; a caller whose ranks share a card initialises
its own gloo group (``torch.distributed.init_process_group("gloo", ...)``)
before calling :func:`main`, which then renders in that group.
"""

from __future__ import annotations

import os
import sys
import time

import torch
import torch.distributed as dist

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize(init_method: str | None = None, world_size: int | None = None, rank: int | None = None) -> None:
    """Join the process group; a no-op when one is initialised already.

    With ``init_method`` or ``world_size`` given, joins through them (a
    ``tcp://`` or ``file://`` address, or the environment's); else, where
    ``torchrun``'s environment is present (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``), through it; else does nothing. A
    failure to join, with explicit arguments or a detected environment,
    propagates. The group takes PyTorch's default backends."""
    if dist.is_initialized():
        return
    if init_method is not None or world_size is not None:
        dist.init_process_group(init_method=init_method, world_size=world_size or -1,
                                rank=-1 if rank is None else rank)
    elif all(k in os.environ for k in _TORCHRUN_ENV):
        dist.init_process_group(init_method="env://")


def ensure_group() -> bool:
    """:func:`initialize`, and where that joins nothing, a group of this
    process alone -> whether this call created the group (False where the
    caller had initialised one, which is then used as it is)."""
    if dist.is_initialized():
        return False
    initialize()
    if not dist.is_initialized():
        dist.init_process_group(store=dist.HashStore(), rank=0, world_size=1)
    return True


def render_distributed(scene, width: int, height: int, spp: int, key, passes: int = 1, config=None,
                       engine: str = "auto", mesh=None):
    """The mean of ``passes`` passes sharded over every rank with the
    CLI's engine choice (``auto``: K1 on a CUDA scene that the megakernel
    takes, else the wavefront), pass p with ``key.fold_in(p)`` -> the [H,
    W, 4] image as numpy on rank 0, None elsewhere. ``mesh`` defaults to
    the default group on the scene's device."""
    from ..models.integrator import RenderConfig
    from ..ops.rng import as_key
    from ..models.engine import select_engine
    from .render import make_mesh, render_pass_sharded_engine

    config = config or RenderConfig()
    mesh = mesh or make_mesh(device=scene.device)
    engine = select_engine(scene, engine)
    key = as_key(key)
    total = None
    for p in range(passes):
        img = render_pass_sharded_engine(engine, scene, key.fold_in(p), width, height, spp, config, mesh)
        total = img if total is None else total + img
    total = total / passes
    return total.cpu().numpy() if mesh.rank == 0 else None


def main(argv=None) -> int:
    import argparse

    from ..scene import parser as scene_parser
    from ..utils.format import format_si
    from ..utils.image import save_png
    from .render import make_mesh

    ap = argparse.ArgumentParser(description="render a scene across the processes of a torchrun job")
    ap.add_argument("scene")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--passes", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0, help="u32 seed of the render's key")
    ap.add_argument("--engine", default="auto", choices=["auto", "mega", "fast", "parity"])
    ap.add_argument("--device", default="cuda", help="cuda (each rank's card) or cpu")
    ap.add_argument("--out", default="out.png")
    args = ap.parse_args(argv)

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print(f"error: --device {args.device} but PyTorch sees no CUDA device; pass --device cpu", file=sys.stderr)
        return 2
    created = ensure_group()
    try:
        mesh = make_mesh(device=args.device)
        scene = scene_parser.load(args.scene, args.width / args.height, mesh.device)
        t0 = time.time()
        img = render_distributed(scene, args.width, args.height, args.spp, args.seed, args.passes,
                                 engine=args.engine, mesh=mesh)
        if img is not None:
            dt = time.time() - t0
            n = args.width * args.height * int(args.spp**0.5) ** 2 * args.passes
            print(f"{mesh.size} processes on {mesh.device.type}: {format_si(n / dt)} samples/s")
            save_png(args.out, img)
    finally:
        if created:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
