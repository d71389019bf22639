"""Inverse rendering: recover scene parameters from a target image by Adam on
the gradients of a differentiable render.

Port of ``kajo_tpu/diff/inverse.py`` (BASELINE.md config 4: recover sphere
position, radius and albedo from a target render). Three engines:

  * ``mega``: the render is ``megakernel_grad.make_diff_renderer``, K1
    forward and, in the backward, K3 for the colours and the background and
    K4 for sphere centres and radii (interior terms; visibility detached);
  * ``mega-fwd``: one forward-mode pass (K2) per optimised scalar and render,
    for the few scalars of a sphere's position (``param_mask`` picks them; at
    most 64);
  * ``jax`` (the JAX package's name for it): the differentiable budget
    engine ``models/wavefront.py:render_pass_budget`` under autograd, which
    differentiates every scene tensor, the material fields K3/K4 do not take
    (``specular_exponent``, ``refractive_index``, ``transparency``) too, on
    dense scenes and, through K5 and the nearest hit's VJP, streamed ones.

``auto`` takes ``mega`` on a CUDA scene that K3 (and, for geometry, K4)
takes when every optimised parameter is one they differentiate, and ``jax``
everywhere else.

The loss (:func:`render_loss`) is the two-sample cross-estimator
mean((X1 - T)(X2 - T)) of two renders with independent seeds, whose
expectation is (E[X] - T)^2: unlike the plain MSE of one noisy render it has
no variance term pulling the optimum toward darker parameters.
``loss_clip`` clamps renders and target before comparing (HDR light pixels
otherwise swamp the loss); ``mega-fwd`` masks the tangents of clamped pixels
the same way. The clamp is ``minimum(maximum(x, 0), clip)``, whose
derivative splits ties, as ``jnp.clip``'s does.

Seeds are u32 integers: a step renders with two of them (the JAX step splits
a threefry key in two; the port takes the seeds, by default
``pass_seed(seed, 2 i)`` and ``pass_seed(seed, 2 i + 1)`` of step i), so
engines ``mega`` and ``jax`` render the same seeds at a step.

``edge_gradients`` (and ``shadow_edges``) add the boundary terms of
``diff/edges.py`` on engines ``mega`` and ``jax``: one zero-valued term,
whose backward is the silhouette (and shadow) boundary gradient, is added to
both renders, under a third key of its own (``CounterKey(seed).fold_in(i)``
of step i); a step without them keeps its two seeds and its bits. Engine
``mega-fwd`` refuses them (the JAX package ignores them there).

Under a ``mesh`` (``parallel/render.py`` ``Mesh``), as in the JAX package,
both renders are the sharded parity pass (``render_pass_sharded``): each
rank renders and differentiates its own lanes, the images are gathered, and
the parameters' gradients are summed over the ranks once
(``parallel.render.sum_gradients``), so every rank takes the gradient of
the whole image's loss and its Adam step leaves the same parameters.
``InverseRenderer(mesh=...)`` takes engine ``jax`` (``auto`` resolves to
it; the JAX package's rule refuses ``mega`` under a mesh) and no boundary
term.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from ..models.integrator import RenderConfig
from ..models.wavefront import render_pass_budget
from ..ops import megakernel_geom, megakernel_grad
from ..ops.megakernel import render_pass_megakernel_jvp, scene_zero_tangent
from ..ops.megakernel_grad import leaf, with_leaves
from ..ops.rng import CounterKey, pass_seed
from ..scene.types import Scene
from .edges import make_silhouette_term

# Parameters the fused backward kernels differentiate: colours through K3,
# sphere geometry through K4. The other material fields (exponent, IOR,
# transparency) take the budget engine, engine jax.
MEGA_DIFF_PARAMS = frozenset({"diffuse", "specular", "emission"})
MEGA_GEOM_PARAMS = frozenset({"sphere_transform", "sphere_radius"})

# Leaves exposed to the optimizer by default (config 4: position/radius/albedo).
DEFAULT_PARAM_SPEC = ("sphere_transform", "sphere_radius", "diffuse")

MAX_FWD_DIRECTIONS = 64


def extract_params(scene: Scene, spec=DEFAULT_PARAM_SPEC) -> Dict[str, torch.Tensor]:
    """The named scene tensors (material fields by their own name), as
    float32 copies."""
    return {name: leaf(scene, name).detach().to(torch.float32).clone() for name in spec}


def apply_params(scene: Scene, params: Dict[str, torch.Tensor]) -> Scene:
    """``scene`` with the named tensors replaced by ``params``."""
    return with_leaves(scene, dict(params))


def cosine_decay(step: int, steps: int, alpha: float = 0.1) -> float:
    """The factor of ``optax.cosine_decay_schedule(lr, steps, alpha)`` at
    ``step``: cosine from 1 to ``alpha`` over ``steps``, then ``alpha``."""
    t = min(step, steps) / steps
    return (1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t)) + alpha


def make_adam(params: Dict[str, torch.Tensor], learning_rate: float, decay_steps: int = 0):
    """Adam over the tensors of ``params`` (made leaves that require grad),
    with ``optax.adam``'s defaults (betas 0.9, 0.999, eps 1e-8 outside the
    square root), and, for ``decay_steps`` > 0, the cosine decay to 10% of
    ``optax.cosine_decay_schedule`` -> (optimizer, scheduler or None). Step
    the scheduler after the optimizer."""
    leaves = [p.requires_grad_(True) for p in params.values()]
    opt = torch.optim.Adam(leaves, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    sched = None
    if decay_steps:
        sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda i: cosine_decay(i, decay_steps))
    return opt, sched


def clip(x: torch.Tensor, hi) -> torch.Tensor:
    """x clamped to [0, hi], with ``jnp.clip``'s derivative (ties split)."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_tensor(hi))


def cross_loss(i1: torch.Tensor, i2: torch.Tensor, target: torch.Tensor, loss_clip=None) -> torch.Tensor:
    """mean((i1 - t)(i2 - t)) over the RGB of two renders and the target."""
    t, i1, i2 = target[..., :3], i1[..., :3], i2[..., :3]
    if loss_clip is not None:
        t, i1, i2 = clip(t, loss_clip), clip(i1, loss_clip), clip(i2, loss_clip)
    return torch.mean((i1 - t) * (i2 - t))


def render_loss(params: Dict[str, torch.Tensor], scene: Scene, target: torch.Tensor, seed1: int, seed2: int,
                width: int, height: int, spp: int, config: RenderConfig = RenderConfig(), mesh=None,
                loss_clip=None, render=None, edge=None) -> torch.Tensor:
    """The cross-estimator loss of two renders of ``scene`` (budget-engine
    passes unless ``render`` is given) with ``params`` put in, with u32
    seeds ``seed1`` and ``seed2`` (the JAX package splits a key into the
    two), against ``target``; differentiable in ``params``.

    Every engine's step but ``mega-fwd`` takes its loss here: ``render(scene,
    seed)`` replaces the budget pass (engine ``mega`` gives its fused
    renderer), and ``edge(scene)``, a zero-valued boundary term, is added to
    both renders. Under a ``mesh`` both renders are the sharded parity pass,
    and the gradient on every rank is the whole image's (see the module
    docstring); it takes neither ``render`` nor ``edge``."""
    if mesh is not None:
        return _render_loss_sharded(params, scene, target, seed1, seed2, width, height, spp, config, mesh,
                                    loss_clip, render, edge)
    updated = apply_params(scene, params)
    if render is None:
        def render(s, seed):
            return render_pass_budget(s, seed, width, height, spp, config)
    i1, i2 = render(updated, seed1), render(updated, seed2)
    if edge is not None:
        term = edge(updated)
        i1, i2 = i1 + term, i2 + term
    return cross_loss(i1, i2, target, loss_clip)


def _render_loss_sharded(params, scene, target, seed1, seed2, width, height, spp, config, mesh, loss_clip,
                         render, edge):
    from ..parallel.render import render_pass_sharded, sum_gradients

    check_mesh(mesh)
    if render is not None or edge is not None:
        raise ValueError("under a mesh the loss renders the sharded parity pass: it takes no render and no edge term")
    summed = sum_gradients(mesh, params)
    updated = apply_params(scene, summed)
    i1 = render_pass_sharded(updated, seed1, width, height, spp, config, mesh)
    i2 = render_pass_sharded(updated, seed2, width, height, spp, config, mesh)
    # + 0 * every parameter: each rank's backward must reach the one
    # all_reduce of sum_gradients, whatever its lanes depend on
    anchor = sum(p.sum() for p in summed.values()) * 0.0
    return cross_loss(i1, i2, target, loss_clip) + anchor


def check_mesh(mesh) -> None:
    """Raise a TypeError unless ``mesh`` is None or a ``parallel.render.Mesh``."""
    from ..parallel.render import Mesh

    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a kajo_tpu_torch.parallel.render.Mesh (make_mesh()), not {type(mesh).__name__}")


@dataclasses.dataclass
class InverseRenderer:
    """Adam loop recovering scene parameters from a target image."""

    scene: Scene
    target: torch.Tensor
    width: int
    height: int
    spp: int = 4
    learning_rate: float = 2e-2
    config: RenderConfig = RenderConfig()
    mesh: Any = None
    param_spec: tuple = DEFAULT_PARAM_SPEC
    decay_steps: int = 0  # >0: cosine-decay the lr to 10% over this many steps
    # "auto": engine mega on a CUDA scene that K3 (and, for geometry, K4)
    # takes, when every optimised parameter is one they differentiate; else
    # engine jax, the budget engine
    engine: str = "auto"
    loss_clip: Any = None  # clamp render+target in the loss (HDR stability)
    # add the silhouette boundary term (diff/edges.py) to the renders'
    # backward: needed wherever a position or radius must be recovered
    # through visibility changes (engines mega and jax)
    edge_gradients: bool = False
    n_edge: int = 256
    # also the NEE-visibility (shadow) boundary term: for a sphere recovered
    # from its cast shadow
    shadow_edges: bool = False
    n_shadow_edge: int = 4
    # engine "mega-fwd": {name: bool tensor} restricting the scalars that get
    # a direction (e.g. one sphere's translation column)
    param_mask: Any = None
    seed: int = 0  # u32 seed of the default per-step seeds

    def __post_init__(self):
        check_mesh(self.mesh)
        spec = set(self.param_spec)
        geom = spec & MEGA_GEOM_PARAMS
        if self.engine == "auto":
            fused = (
                self.mesh is None
                and self.scene.device.type == "cuda"
                and megakernel_grad.supports(self.scene)
                and spec <= (MEGA_DIFF_PARAMS | MEGA_GEOM_PARAMS)
                and (not geom or megakernel_geom.supports(self.scene, self.config))
            )
            self.engine = "mega" if fused else "jax"
        if self.engine not in ("mega", "mega-fwd", "jax"):
            raise ValueError(f"unknown engine {self.engine!r}")
        edges = self.edge_gradients or self.shadow_edges
        if self.mesh is not None and (self.engine != "jax" or edges):
            raise ValueError("under a mesh the inverse render takes engine jax (the sharded parity pass) and no "
                             f"boundary term; got engine {self.engine!r}, edge terms {edges}")
        if edges and self.engine == "mega-fwd":
            raise ValueError("engine mega-fwd takes no boundary terms (edge_gradients, shadow_edges); use engine mega or jax")
        if self.engine == "mega" and not spec <= (MEGA_DIFF_PARAMS | MEGA_GEOM_PARAMS):
            raise ValueError(
                f"engine mega differentiates {sorted(MEGA_DIFF_PARAMS | MEGA_GEOM_PARAMS)}; "
                f"{sorted(spec - MEGA_DIFF_PARAMS - MEGA_GEOM_PARAMS)} need engine jax"
            )
        self.target = self.target.to(self.scene.device)
        self.params = extract_params(self.scene, self.param_spec)
        self.opt, self.sched = make_adam(self.params, self.learning_rate, self.decay_steps)
        self.steps_done = 0
        if self.engine != "mega-fwd":
            # None: render_loss's budget pass (engine jax)
            self._render = (
                megakernel_grad.make_diff_renderer(self.width, self.height, self.spp, self.config,
                                                   geometry=bool(geom))
                if self.engine == "mega" else None
            )
            self._edge_term = (
                make_silhouette_term(self.width, self.height, self.config, self.n_edge, self.shadow_edges,
                                     self.n_shadow_edge)
                if edges else None
            )
        else:
            self._directions = self._fwd_directions()

    def _fwd_directions(self):
        """(name, flat index) of every optimised scalar, in the order of the
        JAX engine."""
        dirs = []
        for name, arr in self.params.items():
            if self.param_mask and name in self.param_mask:
                mask = torch.as_tensor(self.param_mask[name]).reshape(-1)
                idxs = torch.nonzero(mask).reshape(-1).tolist()
            else:
                idxs = range(arr.numel())
            dirs.extend((name, int(i)) for i in idxs)
        if len(dirs) > MAX_FWD_DIRECTIONS:
            raise ValueError(
                f"mega-fwd runs one kernel per optimized scalar; {len(dirs)} directions is too many: "
                "restrict with param_mask"
            )
        return dirs

    def loss_and_grad(self, params: Dict[str, torch.Tensor], seed1: int, seed2: int, edge_key=None):
        """The cross-estimator loss of renders with seeds ``seed1`` and
        ``seed2`` and its gradient -> (loss, {name: gradient}). With the
        boundary terms, ``edge_key`` (a u32 seed or a key) draws them and
        must be given."""
        if self.engine != "mega-fwd":
            if self._edge_term is not None and edge_key is None:
                raise ValueError("the boundary terms (edge_gradients, shadow_edges) need an edge_key")
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            edge = None if self._edge_term is None else (lambda s: self._edge_term(s, edge_key))
            with torch.enable_grad():
                loss = render_loss(leaves, self.scene, self.target, seed1, seed2, self.width, self.height,
                                   self.spp, self.config, mesh=self.mesh, loss_clip=self.loss_clip,
                                   render=self._render, edge=edge)
                # a tensor the render does not reach (transparency: only the
                # detached branch probabilities read it) gets zeros, as in JAX
                grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
            return loss.detach(), {k: torch.zeros_like(v) if g is None else g
                                   for (k, v), g in zip(leaves.items(), grads)}
        return self._loss_and_grad_fwd(params, seed1, seed2)

    def _loss_and_grad_fwd(self, params, seed1, seed2):
        w, h, spp, cfg, c = self.width, self.height, self.spp, self.config, self.loss_clip
        updated = apply_params(self.scene, {k: v.detach() for k, v in params.items()})
        t = self.target[..., :3]
        if c is not None:
            t = clip(t, c)
        npx = w * h * 3
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        loss = None
        for name, i in self._directions:
            tan = {k: torch.zeros_like(v) for k, v in params.items()}
            tan[name].view(-1)[i] = 1.0
            tan_scene = apply_params(scene_zero_tangent(updated), tan)
            i1, d1 = render_pass_megakernel_jvp(updated, tan_scene, seed1, w, h, spp, cfg)
            i2, d2 = render_pass_megakernel_jvp(updated, tan_scene, seed2, w, h, spp, cfg)
            i1, i2, d1, d2 = i1[..., :3], i2[..., :3], d1[..., :3], d2[..., :3]
            if c is not None:
                d1 = torch.where((i1 > 0) & (i1 < c), d1, 0.0)
                d2 = torch.where((i2 > 0) & (i2 < c), d2, 0.0)
                i1, i2 = clip(i1, c), clip(i2, c)
            loss = torch.sum((i1 - t) * (i2 - t)) / npx
            grads[name].view(-1)[i] = torch.sum((i2 - t) * d1 + (i1 - t) * d2) / npx
        return loss, grads

    def step(self, seed1: int | None = None, seed2: int | None = None) -> float:
        """One Adam step on the renders of two u32 seeds (by default the
        step's own two) and, with the boundary terms, the step's own edge
        key -> the loss before the step."""
        if seed1 is None:
            seed1 = pass_seed(self.seed, 2 * self.steps_done)
        if seed2 is None:
            seed2 = pass_seed(self.seed, 2 * self.steps_done + 1)
        edge_key = CounterKey(self.seed).fold_in(self.steps_done)
        loss, grads = self.loss_and_grad(self.params, seed1, seed2, edge_key)
        self.opt.zero_grad(set_to_none=False)
        for name, p in self.params.items():
            p.grad = grads[name].to(p.dtype)
        self.opt.step()
        if self.sched is not None:
            self.sched.step()
        self.steps_done += 1
        return float(loss)

    def current_scene(self) -> Scene:
        return apply_params(self.scene, {k: v.detach() for k, v in self.params.items()})
