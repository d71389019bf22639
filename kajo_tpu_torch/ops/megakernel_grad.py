"""Material gradients of a megakernel pass (Path Replay Backpropagation): a
hand-written CUDA kernel and its plain PyTorch version.

Port of ``kajo_tpu/ops/pallas/megakernel_grad.py``: ``_build_grad_kernel``
(K3) becomes ``csrc/megakernel_grad.cu``; ``supports``, ``material_grads``
and ``make_diff_renderer`` keep their roles.

K3 walks every sample twice with the same PCG4D stream: walk 1 sums the
sample's radiance L, walk 2 replays the path with the radiance still to come,
R_rem, and peels off each local term. Every radiance term is linear in the
colour it carries, so the gradient of a colour c in a throughput factor is
g * R_rem / c (0 for c == 0), and the NEE, emission and background terms give
their coefficients directly. The coin probabilities are detached, so
transparency, IOR and exponent get no gradient, and K3, like the JAX kernel,
ignores ``regen_threshold``.

K3 walks one (lane, sample) item per thread, both walks of its sample, a
warp on one sample of 32 adjacent lanes, and adds to a (K+1) x 9 table per
CTA; beyond MAX_CTAS chunks of ITEMS_PER_CTA items its grid is
RESIDENT_CTAS CTAs, each striding over the chunks (``n_ctas``,
``item_at``: the kernel's rule), and one sum over the CTAs' tables
finishes the gradient.

The plain version is reverse-mode autodiff of the plain walk
(:func:`~.megakernel.trace_lanes_plain`) through
``pack_scene(prepare_scene(.))``, read at the colours and the background.
A CPU scene runs it; a CUDA scene launches K3, or raises.
``kernel_launches`` counts K3's launches.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.integrator import RenderConfig
from ..scene.types import Scene
from . import megakernel
from .megakernel import MAX_KERNEL_OBJECTS, MegaPass, call_kernel, prepare_pass, render_pass_megakernel

MAX_GRAD_OBJECTS = MAX_KERNEL_OBJECTS
ITEMS_PER_CTA = 128  # (lane, sample) items per CTA chunk of K3
MAX_CTAS = 4096  # K3's grid: one chunk a CTA up to this many chunks
RESIDENT_CTAS = 528  # beyond: 132 SMs x 4 CTAs, all resident, striding over the chunks
LANE_GROUP = 32  # lanes whose same sample a warp of K3 walks
_MATERIAL_LEAVES = ("diffuse", "specular", "emission")

kernel_launches = 0


def supports(scene: Scene) -> bool:
    """Rigid and general transforms, 1..512 objects (the forward kernel's
    scope; the material gradient needs only the primal geometry)."""
    return bool(megakernel.supports(scene) and scene.num_objects <= MAX_GRAD_OBJECTS)


def with_leaves(scene: Scene, leaves: dict) -> Scene:
    """``scene`` with some tensors replaced, by name: a material field
    (``diffuse``, ...) or a scene field (``background``,
    ``sphere_transform``, ...)."""
    mats = {k: v for k, v in leaves.items() if not hasattr(scene, k)}
    rest = {k: v for k, v in leaves.items() if hasattr(scene, k)}
    return dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, **mats), **rest)


def leaf(scene: Scene, name: str) -> torch.Tensor:
    return getattr(scene, name) if hasattr(scene, name) else getattr(scene.materials, name)


def cotangent_lanes(ps: MegaPass, cotangent: torch.Tensor) -> torch.Tensor:
    """[H, W, 3 or 4] cotangent of the image -> [3, n_lanes] cotangent of
    the lanes' sums: the image divides them by the pass divisor. (Division
    by a 0-d tensor, not a Python number, as in ``megakernel._image``.)"""
    g = cotangent[..., :3].reshape(ps.width * ps.height, 3)[ps.lane0 :].to(torch.float32)
    return (g / g.new_tensor(ps.divisor)).T.contiguous()


def scene_vjp_plain(
    scene: Scene,
    names,
    seed: int,
    cotangent: torch.Tensor,
    width: int,
    height: int,
    spp: int,
    config: RenderConfig,
    **walk,
) -> dict:
    """Reverse-mode autodiff of Σ cotangent ⊙ image through the plain walk
    and ``pack_scene(prepare_scene(.))`` -> {name: gradient} for the named
    tensors of the scene. ``walk`` goes to ``trace_lanes_plain``."""
    leaves = {n: leaf(scene, n).detach().clone().requires_grad_(True) for n in names}
    with torch.enable_grad():
        ps = prepare_pass(with_leaves(scene, leaves), width, height, spp, config)
        sums = megakernel.trace_lanes_plain(ps, seed, **walk)
        total = (cotangent_lanes(ps, cotangent) * sums).sum()
        grads = torch.autograd.grad(total, list(leaves.values()), allow_unused=True)
    return {n: torch.zeros_like(leaves[n]) if g_ is None else g_ for n, g_ in zip(names, grads)}


def _table(scene: Scene, tab: torch.Tensor) -> dict:
    """[K+1, 9] table -> the gradients' dictionary."""
    k = scene.num_objects
    return {
        "diffuse": tab[:k, 0:3],
        "specular": tab[:k, 3:6],
        "emission": tab[:k, 6:9],
        "background": tab[k, 0:3],
    }


def n_items(n_lanes: int, eff: int) -> int:
    """K3's items: the lanes rounded up to whole groups of LANE_GROUP, x eff."""
    return -(-n_lanes // LANE_GROUP) * LANE_GROUP * eff


def n_ctas(n_lanes: int, eff: int) -> int:
    """K3's grid (``n_ctas`` in ``csrc/megakernel_grad.cu``): one CTA per
    chunk of ITEMS_PER_CTA items up to MAX_CTAS chunks, else RESIDENT_CTAS;
    CTA b walks the chunks b, b + n_ctas, ..."""
    chunks = -(-n_items(n_lanes, eff) // ITEMS_PER_CTA)
    return chunks if chunks <= MAX_CTAS else RESIDENT_CTAS


def item_at(item, eff: int):
    """Item (an int or an integer tensor) -> (lane index, sample), as the
    kernel's ``item_at``: the eff samples of a group of LANE_GROUP lanes,
    sample-major, so a warp walks one sample of 32 adjacent lanes (a lane
    index >= n_lanes walks nothing)."""
    r = item % (LANE_GROUP * eff)
    return item // (LANE_GROUP * eff) * LANE_GROUP + r % LANE_GROUP, r // LANE_GROUP


def launch_kernel(ps: MegaPass, g: torch.Tensor, seed: int) -> torch.Tensor:
    """Launch K3 on the current stream -> [K+1, 9] table: cols 0-2
    diffuse, 3-5 specular, 6-8 emission per object, row K background. Each
    CTA writes its own table; one sum over the CTAs finishes it."""
    global kernel_launches
    n_cta = n_ctas(ps.n_lanes, ps.eff)
    out = torch.empty((n_cta, ps.n_planes + ps.n_spheres + 1, 9), dtype=torch.float32, device=ps.packed.device)
    call_kernel("megakernel_grad.cu", "kajo_material_grads", (ps.packed, g, out), ps.params(seed))
    kernel_launches += 1
    return out.sum(0)


def _k3_config(config: RenderConfig) -> RenderConfig:
    # K3's walks, like the JAX kernel's, never cull by throughput
    return dataclasses.replace(config, regen_threshold=0.0)


def material_grads_plain(
    scene: Scene,
    seed: int,
    cotangent: torch.Tensor,
    width: int,
    height: int,
    spp: int,
    config: RenderConfig = RenderConfig(),
) -> dict:
    """K3's plain version on the scene's device (see the module docstring)."""
    names = (*_MATERIAL_LEAVES, "background")
    gr = scene_vjp_plain(scene, names, seed, cotangent, width, height, spp, _k3_config(config))
    return {n: gr[n][..., :3] for n in names}


def material_grads(
    scene: Scene,
    seed: int,
    cotangent: torch.Tensor,
    width: int,
    height: int,
    spp: int,
    config: RenderConfig = RenderConfig(),
) -> dict:
    """d(Σ cotangent ⊙ image)/d(materials) for the pass of u32 seed ``seed``.

    ``cotangent``: [H, W, 3 or 4] on the scene's device. Returns
    dict(diffuse=[K, 3], specular=[K, 3], emission=[K, 3], background=[3])."""
    if not megakernel.uses_kernel(scene.device):
        return material_grads_plain(scene, seed, cotangent, width, height, spp, config)
    if not supports(scene):
        raise ValueError(f"the gradient kernel takes 1..{MAX_GRAD_OBJECTS} objects, got {scene.num_objects}")
    ps = prepare_pass(scene, width, height, spp, _k3_config(config))
    return _table(scene, launch_kernel(ps, cotangent_lanes(ps, cotangent), seed))


def make_diff_renderer(
    width: int,
    height: int,
    spp: int,
    config: RenderConfig = RenderConfig(),
    geometry: bool = False,
):
    """A render differentiable in the colours and the background.

    Returns ``render(scene, seed) -> [H, W, 4]``, one pass of u32 seed
    ``seed`` (K1 on a CUDA scene), whose backward runs K3: gradients reach
    ``materials.diffuse``, ``specular``, ``emission`` (alpha 0) and
    ``background``; transparency, IOR and exponent get none. With
    ``geometry=True`` the backward also runs K4
    (``megakernel_geom.geometry_grads``): the translation column of
    ``sphere_transform`` and ``sphere_radius`` get interior gradients, the
    rest of the transform 0 (visibility is detached)."""

    names = (*_MATERIAL_LEAVES, "background") + (("sphere_transform", "sphere_radius") if geometry else ())

    class Render(torch.autograd.Function):
        @staticmethod
        def forward(ctx, scene, seed, *tensors):
            ctx.scene, ctx.seed = scene, seed
            return render_pass_megakernel(scene, seed, width, height, spp, config)

        @staticmethod
        def backward(ctx, g):
            scene, seed = ctx.scene, ctx.seed
            gr = material_grads(scene, seed, g, width, height, spp, config)
            out = [torch.nn.functional.pad(gr[n], (0, 1)) for n in _MATERIAL_LEAVES]
            out.append(torch.nn.functional.pad(gr["background"], (0, 1)))
            if geometry:
                from .megakernel_geom import geometry_grads

                gg = geometry_grads(scene, seed, g, width, height, spp, config)
                st = torch.zeros_like(scene.sphere_transform)
                st[:, :3, 3] = gg["center"]
                out += [st, gg["radius"]]
            return (None, None, *out)

    def render(scene: Scene, seed: int) -> torch.Tensor:
        return Render.apply(scene, seed, *(leaf(scene, n) for n in names))

    return render
