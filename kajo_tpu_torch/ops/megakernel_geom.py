"""Sphere geometry gradients of a megakernel pass: a hand-written CUDA kernel
and its plain PyTorch version.

Port of ``kajo_tpu/ops/pallas/megakernel_geom.py``: ``_build_geom_kernel``
(K4) becomes ``csrc/megakernel_geom.cu``; ``TRACK_SLOTS``, ``supports`` and
``geometry_grads`` keep their roles.

A path's radiance depends on the geometry of the few distinct spheres it
hits (visibility is discrete, so detached), so reverse mode over every
sphere's centre and r² collapses to a few forward-mode directions per path.
K4 walks each sample once to record the distinct non-light spheres it hits
(up to ``TRACK_SLOTS``) and, with NEE on, which lights it touched (its NEE
term counted, or it hit the light); then, for each recorded sphere j, it
replays the same path once with four tangents, the directions p in (cx, cy,
cz, r²) injected only into sphere j's records: the rigid record's field p,
or the general record's invt (d invt/dc = -inv3) and r², and the light
record when j is a light. The shadow ray is detached. The kernel's fourth
direction is d/d(r²), chained to d/dr = 2r d/d(r²). One thread walks one
(lane, sample) item's discovery; a CTA queues its items' (item, sphere)
replays and spreads them over its threads (``csrc/megakernel_geom.cu``).

The plain version is reverse-mode autodiff of the plain walk through
``pack_scene(prepare_scene(.))`` to ``sphere_transform[:, :3, 3]`` and
``sphere_radius``. While ``max_depth + 1 <= TRACK_SLOTS`` no path can fill
the slots and that is all; deeper, a discovery walk first finds each lane's
tracked spheres per sample, and the walk detaches the records of the
others, as K4 drops them.

The reference builds its per-light replay flags as ``jnp.int32(1 << li)``,
which overflows from the 32nd light on (``megakernel_geom.py:742``, :784):
with NEE on it cannot trace a scene of 32 lights or more. The port keeps
that limit and says so: ``supports`` is False and ``geometry_grads`` raises
ValueError.
"""

from __future__ import annotations

import torch

from ..models.integrator import RenderConfig
from ..scene.types import Scene
from . import megakernel
from .megakernel import MegaPass, call_kernel, prepare_pass
from .megakernel_grad import cotangent_lanes, scene_vjp_plain

TRACK_SLOTS = 8
MAX_NEE_LIGHTS = 31  # the reference's int32 light bitmask
ITEMS_PER_CTA = 128  # (lane, sample) items per CTA chunk of K4
MAX_CTAS = 4096  # K4's grid: one table each; a CTA strides over the chunks beyond

kernel_launches = 0


def supports(scene: Scene, config: RenderConfig = RenderConfig()) -> bool:
    """Rigid and general transforms, 1..512 objects with at least one
    sphere, and with NEE on at most 31 lights."""
    nee = config.direct_lighting and scene.num_lights > 0
    return bool(
        megakernel.supports(scene) and scene.num_spheres > 0 and not (nee and scene.num_lights > MAX_NEE_LIGHTS)
    )


def _check(scene: Scene, config: RenderConfig) -> None:
    if config.direct_lighting and scene.num_lights > MAX_NEE_LIGHTS:
        raise ValueError(
            f"geometry gradients with NEE take at most {MAX_NEE_LIGHTS} lights, got {scene.num_lights}: "
            "the reference's per-light replay bitmask is an int32"
        )
    if not supports(scene, config):
        raise ValueError(f"the geometry kernel takes 1..512 objects with a sphere, got {scene.num_objects}")


def tracked_spheres(ps: MegaPass, seed: int, light_indices) -> torch.Tensor:
    """K4's slot rule on the plain walk -> bool [n_lanes, eff, S]: per lane
    and sample, the first TRACK_SLOTS distinct non-light spheres its path
    hits (lights count as any sphere with NEE off), and every light with
    NEE on."""
    log = []
    with torch.no_grad():
        megakernel.trace_lanes_plain(ps, seed, hit_log=log)
    P, S, dev = ps.n_planes, ps.n_spheres, ps.packed.device
    n = ps.n_lanes
    light_spheres = torch.tensor(light_indices if ps.nee_on else (), dtype=torch.int64, device=dev)
    is_light = torch.zeros(S, dtype=torch.bool, device=dev)
    is_light[light_spheres] = True
    tracked = torch.zeros((n, ps.eff, S), dtype=torch.bool, device=dev)
    count = torch.zeros((n, ps.eff), dtype=torch.int64, device=dev)
    lanes = torch.arange(n, device=dev)
    for sample, obj, active in log:
        sid = (obj - P).clamp_min(0)
        smp = sample.clamp_max(ps.eff - 1)
        new = active & (obj >= P) & ~is_light[sid] & ~tracked[lanes, smp, sid] & (count[lanes, smp] < TRACK_SLOTS)
        tracked[lanes[new], smp[new], sid[new]] = True
        count[lanes[new], smp[new]] += 1
    tracked[:, :, light_spheres] = True
    return tracked


def geometry_grads_plain(
    scene: Scene,
    seed: int,
    cotangent: torch.Tensor,
    width: int,
    height: int,
    spp: int,
    config: RenderConfig = RenderConfig(),
) -> dict:
    """K4's plain version on the scene's device (see the module docstring)."""
    _check(scene, config)
    walk = {}
    if config.max_depth + 1 > TRACK_SLOTS:
        ps = prepare_pass(scene, width, height, spp, config)
        walk["tracked"] = tracked_spheres(ps, seed, scene.light_indices)
    gr = scene_vjp_plain(
        scene, ("sphere_transform", "sphere_radius"), seed, cotangent, width, height, spp, config, **walk
    )
    return {"center": gr["sphere_transform"][:, :3, 3], "radius": gr["sphere_radius"]}


def launch_kernel(ps: MegaPass, g: torch.Tensor, seed: int) -> torch.Tensor:
    """Launch K4 on the current stream -> [S, 4] table: d/dcx, d/dcy,
    d/dcz, d/d(r²) per sphere. Each CTA writes its own table; one sum over
    the CTAs finishes it."""
    global kernel_launches
    n_cta = min(-(-ps.n_lanes * ps.eff // ITEMS_PER_CTA), MAX_CTAS)  # the kernel's n_ctas
    out = torch.empty((n_cta, ps.n_spheres, 4), dtype=torch.float32, device=ps.packed.device)
    call_kernel("megakernel_geom.cu", "kajo_geometry_grads", (ps.packed, g, out), ps.params(seed))
    kernel_launches += 1
    return out.sum(0)


def geometry_grads(
    scene: Scene,
    seed: int,
    cotangent: torch.Tensor,
    width: int,
    height: int,
    spp: int,
    config: RenderConfig = RenderConfig(),
) -> dict:
    """d(Σ cotangent ⊙ image)/d(sphere geometry) for the pass of u32 seed
    ``seed`` -> dict(center=[S, 3], radius=[S]). Interior terms only
    (visibility detached); a light sphere's NEE-sampler role (its sample
    positions and solid-angle pdfs) is differentiated too."""
    if not megakernel.uses_kernel(scene.device):
        return geometry_grads_plain(scene, seed, cotangent, width, height, spp, config)
    _check(scene, config)
    ps = prepare_pass(scene, width, height, spp, config)
    table = launch_kernel(ps, cotangent_lanes(ps, cotangent), seed)
    radius = torch.sqrt(torch.clamp_min(scene.sphere_radius * scene.sphere_radius, 0.0))
    return {"center": table[:, 0:3], "radius": 2.0 * radius * table[:, 3]}
