"""Rendering with the lanes split over the ranks of a process group, port of
``kajo_tpu/parallel/render.py``.

kajo_tpu shards a pass's lanes over the ``data`` axis of a
``jax.sharding.Mesh`` and lets XLA partition the work. Here a :class:`Mesh`
is a ``torch.distributed`` process group and the device of this process's
rank: each rank renders its contiguous block of the global lanes (the lane
count padded to a multiple of the world size, as kajo_tpu pads it) and the
blocks are gathered into the replicated image with one ``all_gather``
(NCCL for CUDA tensors, gloo for CPU tensors, or whatever backend the
caller's group names). Lane ids, and with them the random streams, are
global, so a block renders what the same lanes render unsharded.

  * :func:`render_pass_sharded`: the parity engine (``models/integrator.py``),
    differentiable; each stratum's jitter and each bounce's uniforms are the
    rank's columns of a draw over all padded lanes, so the pass equals
    itself at any world size that pads the lanes alike;
  * :func:`render_pass_fast_sharded`: the regenerating wavefront, one lane a
    pixel, through K5/K6 on streamed scenes;
  * :func:`render_pass_megakernel_sharded`: K1 on the rank's lanes;
  * :func:`render_pass_sharded_engine` routes the three, and
    :func:`render_image_sharded` averages parity passes.

A sharded entry point renders on the mesh's device and nowhere else: the
scene must be there (a CUDA scene launches the kernels on the rank's card,
or raises). Every rank must call every entry point with the same arguments,
in the same order: the gathers are collectives.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch
import torch.distributed as dist

from ..models.engine import render_pass_engine, select_engine
from ..models.integrator import RenderConfig, render_pass, render_samples
from ..models.wavefront import _seed_tensor, render_lanes, render_pass_fast
from ..ops.geometry import generate_rays, prepare_scene
from ..ops.megakernel import lane_sums, prepare_pass, render_pass_megakernel
from ..ops.rng import as_key, uniform_columns
from ..scene.types import Scene


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A process group and the device this process's rank renders on."""

    group: Any  # a ProcessGroup; None is the default group
    rank: int
    size: int
    device: torch.device


def make_mesh(group=None, device=None) -> Mesh:
    """The mesh of ``group`` (default: the default group) on ``device``.

    ``device`` None takes this rank's card where the group's backend is
    NCCL, else the CPU; ``"cuda"`` without an index takes this rank's card
    (``LOCAL_RANK``, else the rank, modulo the cards) and makes it the
    current device. Raises when no process group is initialised, and for a
    device whose tensors the group's backends do not take."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialised process group: torch.distributed.init_process_group, "
            "or kajo_tpu_torch.parallel.multihost.initialize"
        )
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    config = dist.get_backend_config(group)  # e.g. "cpu:gloo,cuda:nccl"
    backends = dict(part.split(":") for part in config.split(","))
    device = torch.device(("cuda" if backends.get("cuda") == "nccl" else "cpu") if device is None else device)
    if device.type not in backends:
        raise ValueError(f"the process group ({config}) takes no {device.type} tensors")
    if device.type == "cuda":
        if device.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return Mesh(group, rank, size, device)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def lane_block(n: int, mesh: Mesh) -> tuple:
    """This rank's block of ``n`` lanes padded to a multiple of the world
    size -> (lo, hi, padded): lanes lo .. hi - 1 of ``padded``; those at or
    past ``n`` are pad lanes, whose results are dropped."""
    padded = _round_up(n, mesh.size)
    block = padded // mesh.size
    return mesh.rank * block, (mesh.rank + 1) * block, padded


class _GatherLanes(torch.autograd.Function):
    """all_gather of equal [block, ...] blocks in rank order -> [padded, ...].

    Every rank goes on with the same gathered tensor, so the gradient a rank
    receives for it is every rank's; its backward keeps the rows of its own
    block and runs no collective (summing the ranks' gradients of the
    replicated scene is the caller's: see ``diff/inverse.py``)."""

    @staticmethod
    def forward(ctx, block, mesh):
        ctx.rows = (mesh.rank * block.shape[0], (mesh.rank + 1) * block.shape[0])
        parts = [torch.empty_like(block) for _ in range(mesh.size)]
        dist.all_gather(parts, block.contiguous(), group=mesh.group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        lo, hi = ctx.rows
        return grad[lo:hi], None


def gather_lanes(mesh: Mesh, block: torch.Tensor) -> torch.Tensor:
    """The ranks' lane blocks [block, ...] in rank order -> [padded, ...],
    replicated; differentiable (see :class:`_GatherLanes`)."""
    return _GatherLanes.apply(block, mesh)


class _SumGrads(torch.autograd.Function):
    """Identity on tensors whose backward sums their gradients over the
    mesh's ranks, in one all_reduce."""

    @staticmethod
    def forward(ctx, mesh, *tensors):
        ctx.mesh = mesh
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=ctx.mesh.group)
        out, i = [], 0
        for g in grads:
            out.append(flat[i : i + g.numel()].view_as(g))
            i += g.numel()
        return (None, *out)


def sum_gradients(mesh: Mesh, tensors: dict) -> dict:
    """``tensors`` as they are, whose gradients are summed over the ranks:
    replicated parameters, each rank differentiating its own lanes, then
    get the gradient of the whole image on every rank."""
    names = list(tensors)
    out = _SumGrads.apply(mesh, *(tensors[k] for k in names))
    return dict(zip(names, out))


def check_scene(scene: Scene, mesh: Mesh) -> None:
    """Raise unless the scene lies on the mesh's device."""
    if scene.device != mesh.device:
        raise ValueError(f"the scene is on {scene.device}, this rank renders on {mesh.device}; move the scene there")


def render_pass_sharded(scene: Scene, key, width: int, height: int, spp: int,
                        config: RenderConfig = RenderConfig(), mesh: Mesh | None = None) -> torch.Tensor:
    """One parity-engine pass with the lanes split over ``mesh`` -> [H, W,
    4], replicated; ``mesh`` None is ``integrator.render_pass``.

    As kajo_tpu's: stratum i draws the jitter ``key.fold_in(i).uniform((2,
    padded))`` and traces ``render_samples(..., key.fold_in(i).fold_in(7919))``;
    a rank takes its columns of both draws. Pad lanes trace pixel (0, 0)
    and are dropped. Differentiable in the scene's tensors: each rank's
    graph holds its own lanes (see :func:`sum_gradients`)."""
    if mesh is None:
        return render_pass(scene, key, width, height, spp, config)
    check_scene(scene, mesh)
    key = as_key(key)
    prep = prepare_scene(scene)
    dev = mesh.device
    grid = max(int(spp**0.5), 1)
    eff = grid * grid
    divisor = float(spp if config.kajo_spp_quirk else eff)
    n = width * height
    lo, hi, padded = lane_block(n, mesh)
    lane = torch.arange(lo, hi, dtype=torch.int64, device=dev)
    real = lane < n
    xs = torch.where(real, lane % width, 0).to(torch.float32)
    ys = torch.where(real, lane // width, 0).to(torch.float32)
    total = torch.zeros((hi - lo, 4), dtype=torch.float32, device=dev)
    for idx in range(eff):
        k = key.fold_in(idx)
        u = uniform_columns(k, (2, padded), lo, hi, dev)
        sx = (xs + (float(idx % grid) + u[0]) / grid) / width
        sy = ((height - ys) + (float(idx // grid) + u[1]) / grid) / height
        o, d = generate_rays(prep.camera, sx, sy)
        total = total + render_samples(prep, o, d, k.fold_in(7919), config, columns=(lo, padded))
    return (gather_lanes(mesh, total)[:n] / divisor).reshape(height, width, 4)


def render_pass_fast_sharded(scene: Scene, seed: int, width: int, height: int, spp: int,
                             config: RenderConfig = RenderConfig(), mesh: Mesh | None = None) -> torch.Tensor:
    """One regenerating-wavefront pass with u32 pass seed ``seed`` and the
    lanes split over ``mesh`` -> [H, W, 4], replicated; ``mesh`` None is
    ``wavefront.render_pass_fast``.

    As kajo_tpu's: one lane a pixel (lane = pixel id, global), each rank's
    wavefront running until its own lanes are done, through K5/K6 on a
    streamed scene. On a dense scene the image equals ``render_pass_fast``'s
    bit for bit. On a streamed scene it does not: the unsharded pass splits
    each pixel's samples over ``LANE_MULT`` lanes in a tiled pixel order,
    which this one does not, so their streams differ. Pad lanes trace rays
    below the image and are dropped."""
    if mesh is None:
        return render_pass_fast(scene, seed, width, height, spp, config)
    check_scene(scene, mesh)
    prep = prepare_scene(scene)
    dev = mesh.device
    grid = max(int(spp**0.5), 1)
    eff = grid * grid
    divisor = float(spp if config.kajo_spp_quirk else eff)
    n = width * height
    lo, hi, _ = lane_block(n, mesh)
    lane = torch.arange(lo, hi, dtype=torch.int64, device=dev)
    rgb, _, _ = render_lanes(prep, lane, _seed_tensor(seed, dev), width, height, eff, grid, config)
    rgb = gather_lanes(mesh, rgb)[:n]
    img = torch.cat([rgb / divisor, torch.ones((n, 1), dtype=torch.float32, device=dev)], 1)
    return img.reshape(height, width, 4)


def render_pass_megakernel_sharded(scene: Scene, seed: int, width: int, height: int, spp: int,
                                   config: RenderConfig = RenderConfig(), mesh: Mesh | None = None) -> torch.Tensor:
    """One megakernel pass with u32 pass seed ``seed`` and the lanes split
    over ``mesh`` -> [H, W, 4], replicated; ``mesh`` None is
    ``megakernel.render_pass_megakernel``.

    Rank r traces its block of the lanes padded to a multiple of the world
    size, clipped to W*H: one K1 launch on a CUDA scene (the plain version
    on a CPU one); a block of pad lanes only launches nothing. The [3,
    block] sums are gathered in rank order, so with global lane ids the
    image equals ``render_pass_megakernel``'s bit for bit."""
    if mesh is None:
        return render_pass_megakernel(scene, seed, width, height, spp, config)
    check_scene(scene, mesh)
    n = width * height
    lo, hi, _ = lane_block(n, mesh)
    ps = prepare_pass(scene, width, height, spp, config, min(lo, n), min(hi, n))
    block = torch.zeros((hi - lo, 3), dtype=torch.float32, device=mesh.device)
    block[: ps.n_lanes] = lane_sums(ps, seed).T
    rgb = gather_lanes(mesh, block)[:n]
    img = torch.cat([rgb / rgb.new_tensor(ps.divisor), torch.ones((n, 1), dtype=torch.float32, device=rgb.device)], 1)
    return img.reshape(height, width, 4)


def render_pass_sharded_engine(engine: str, scene: Scene, key, width: int, height: int, spp: int,
                               config: RenderConfig = RenderConfig(), mesh: Mesh | None = None) -> torch.Tensor:
    """A sharded pass of ``engine`` (``auto`` resolved by
    ``models.engine.select_engine``, the CLI's rule, as kajo_tpu's
    ``select_engine_sharded`` resolves it): ``mega`` (K1 on each rank's lanes),
    ``fast`` (the wavefront on each rank's lanes) or ``parity``. ``key`` is
    a u32 seed or a key; ``mega`` and ``fast`` take its ``seed()``, which is
    a u32 seed itself. ``mesh`` None renders unsharded."""
    engine = select_engine(scene, engine)
    seed = as_key(key).seed()
    if mesh is None:
        return render_pass_engine(engine, scene, key if engine == "parity" else seed, width, height, spp, config)
    if engine == "mega":
        return render_pass_megakernel_sharded(scene, seed, width, height, spp, config, mesh)
    if engine == "fast":
        return render_pass_fast_sharded(scene, seed, width, height, spp, config, mesh)
    return render_pass_sharded(scene, key, width, height, spp, config, mesh)


def render_image_sharded(scene: Scene, width: int, height: int, spp: int, key, passes: int = 1,
                         config: RenderConfig = RenderConfig(), mesh: Mesh | None = None) -> torch.Tensor:
    """The mean of ``passes`` sharded parity passes, pass p with
    ``key.fold_in(p)``."""
    key = as_key(key)
    total = torch.zeros((height, width, 4), dtype=torch.float32, device=scene.device)
    for p in range(passes):
        total = total + render_pass_sharded(scene, key.fold_in(p), width, height, spp, config, mesh)
    return total / passes
