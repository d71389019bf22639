"""The object-sharded wavefront: the spheres split over the ranks, the rays
replicated, port of ``kajo_tpu/parallel/objshard.py``.

For scenes too big to hold, or too slow to trace, on one device: each rank
keeps and traces its shard of the spheres (dense, or through K5 on its own
stream packing above ``geometry.STREAM_THRESHOLD``), and the global nearest
hit is reduced over the ranks:

    t          = all_reduce MIN of the rank's t
    winner     = all_reduce MIN of the rank id where it hit at t, else 1 << 30
    hit fields = all_reduce SUM of the unique winner's fields, 0 elsewhere

Everything else (planes, materials, lights, the wavefront's state) is
replicated, so after the reduction every rank shades the same hits and
continues with the same state. Object ids stay global (num_planes + rank *
shard + local index), so NEE's self-exclusion is unchanged. Shadow rays go
through the same reduction, by the nearest hit bounded at |c - o| + r + 1
(``geometry.light_visible``), not through K6.

Collective order: the wavefront stops on an ``any()`` every rank computes
on replicated state, and every dispatch (dense or K5, the NEE form) is
decided by replicated data or by the shard size, which is the same on every
rank. So every rank makes the same collectives in the same order.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..models.integrator import RenderConfig
from ..models.wavefront import _seed_tensor, render_lanes
from ..ops import geometry
from ..ops.geometry import PreparedScene, SurfaceHit, prepare_scene, trace
from ..ops.stream_trace import build_stream_scene
from ..scene.types import Scene
from .render import Mesh, _round_up, check_scene

_NOT_A_WINNER = 1 << 30


def make_objsharded_trace(mesh: Mesh, num_planes: int, shard: int):
    """A ``trace_fn`` giving the global nearest hit over the ranks' sphere
    shards (four all_reduces a call)."""
    group = mesh.group

    def trace_fn(prep_local, o, d, t_max=None):
        h = trace(prep_local, o, d, t_max)
        gobj = torch.where(h.obj >= num_planes, h.obj + mesh.rank * shard, h.obj)
        t_g = h.t.clone()
        dist.all_reduce(t_g, dist.ReduceOp.MIN, group=group)
        hitmask = torch.isfinite(t_g)
        win = (h.t == t_g) & hitmask
        wrank = torch.where(win, mesh.rank, _NOT_A_WINNER)
        dist.all_reduce(wrank, dist.ReduceOp.MIN, group=group)
        mine = (win & (wrank == mesh.rank))[:, None]
        fields = torch.where(mine, torch.cat([h.position, h.normal, h.tangent, h.binormal], 1), 0.0)
        dist.all_reduce(fields, group=group)
        obj_g = torch.where(mine[:, 0], gobj, 0)
        dist.all_reduce(obj_g, group=group)
        h3 = hitmask[:, None]
        pos, nor, tan, bino = fields.split(3, 1)
        return SurfaceHit(
            t=t_g,
            obj=torch.where(hitmask, obj_g, -1),
            position=torch.where(h3, pos, o),
            normal=torch.where(h3, nor, 0.0),
            tangent=torch.where(h3, tan, 0.0),
            binormal=torch.where(h3, bino, 0.0),
            view=d,
        )

    return trace_fn


def _pad_prep_spheres(prep: PreparedScene, s_pad: int) -> PreparedScene:
    """Pad the per-sphere tensors to ``s_pad`` spheres that nothing hits."""
    s = prep.sphere_center.shape[0]
    pad = s_pad - s
    if pad == 0:
        return prep

    def padn(a, fill=0.0):
        if a.shape[0] == 0:  # the object-space fields of a rigid scene
            return a
        return torch.cat([a, a.new_full((pad, *a.shape[1:]), fill)])

    # A pad's centre repeats the last real one, inside the scene's bounds: the
    # shard that receives it builds its own stream packing, whose box slack
    # and Morton quantisation come from its centres' extent, and a far pad
    # would inflate every box of that shard and defeat its block culls.
    # r² = -1 keeps the pads unhittable.
    last = prep.sphere_center[-1:] if s else prep.sphere_center.new_zeros((1, 3))
    return dataclasses.replace(
        prep,
        sphere_center=torch.cat([prep.sphere_center, last.expand(pad, 3)]),
        sphere_radius2=padn(prep.sphere_radius2, -1.0),
        sphere_inv3=padn(prep.sphere_inv3),
        sphere_invt=padn(prep.sphere_invt),
        sphere_fwd3=padn(prep.sphere_fwd3),
        # large, not 0: a det-0 pad would zero its block's min-det cull bound
        # (inv3 = 0 makes a pad's quadratic a == 0: never a hit either way)
        sphere_det=padn(prep.sphere_det, 1e30),
    )


_SPHERE_FIELDS = ("sphere_center", "sphere_radius2", "sphere_inv3", "sphere_invt", "sphere_fwd3", "sphere_det")


def shard_prep(prep: PreparedScene, mesh: Mesh):
    """This rank's shard of a prepared scene -> (local prep, shard size):
    the spheres padded to a multiple of the world size and cut in equal
    contiguous shards, the rest as it is, and the shard's own stream packing
    where the shard is above ``STREAM_THRESHOLD``."""
    s = prep.sphere_center.shape[0]
    shard = _round_up(max(s, 1), mesh.size) // mesh.size
    padded = _pad_prep_spheres(prep, shard * mesh.size)
    lo, hi = mesh.rank * shard, (mesh.rank + 1) * shard
    local = dataclasses.replace(
        padded,
        **{k: getattr(padded, k)[lo:hi] if getattr(padded, k).shape[0] else getattr(padded, k)
           for k in _SPHERE_FIELDS},
        stream_packed=None, stream_boxes=None, stream_perm=None, stream_inv_perm=None, stream_sboxes=None,
    )
    if shard > geometry.STREAM_THRESHOLD:
        packed, boxes, perm, inv_perm, sboxes = build_stream_scene(local)
        local = dataclasses.replace(local, stream_packed=packed, stream_boxes=boxes, stream_perm=perm,
                                    stream_inv_perm=inv_perm, stream_sboxes=sboxes)
    return local, shard


def render_pass_fast_objsharded(scene: Scene, seed: int, width: int, height: int, spp: int,
                                config: RenderConfig = RenderConfig(), mesh: Mesh | None = None) -> torch.Tensor:
    """One regenerating-wavefront pass with u32 pass seed ``seed`` and the
    spheres split over ``mesh`` -> [H, W, 4], replicated.

    One lane a pixel, every lane on every rank; each rank traces its shard
    (K5 on a CUDA scene whose shard is above ``STREAM_THRESHOLD``) and the
    hits are reduced. The image equals the unsharded wavefront's with one
    lane a pixel up to rounding: per-shard block boxes may decide a far
    grazing ray differently, and shadow rays take the nearest hit where the
    unsharded pass may take K6."""
    if mesh is None:
        raise ValueError("render_pass_fast_objsharded needs a mesh (parallel.render.make_mesh)")
    check_scene(scene, mesh)
    dev = mesh.device
    prep = prepare_scene(scene)
    local, shard = shard_prep(prep, mesh)
    grid = max(int(spp**0.5), 1)
    eff = grid * grid
    divisor = float(spp if config.kajo_spp_quirk else eff)
    n = width * height
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    trace_fn = make_objsharded_trace(mesh, prep.plane_nrow.shape[0], shard)
    rgb, _, _ = render_lanes(local, lane, _seed_tensor(seed, dev), width, height, eff, grid, config,
                             trace_fn=trace_fn)
    img = torch.cat([rgb / divisor, torch.ones((n, 1), dtype=torch.float32, device=dev)], 1)
    return img.reshape(height, width, 4)
