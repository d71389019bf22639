"""The gradient path as a whole: ``kajo_tpu_torch.diff.inverse`` and the
inverse-rendering entry point, on the CPU (plain versions of K1-K4).

  * ``extract_params``/``apply_params`` round trips;
  * Adam with the cosine decay to 10% against optax's ``adam`` and
    ``cosine_decay_schedule`` on a fixed sequence of gradients;
  * one engine ``mega`` loss and gradient (``param_spec=("diffuse",)``,
    ``loss_clip=1.0``) at 8x6, 4 spp, ``max_depth=3`` on caustics against
    kajo_tpu's, composed from its own ``render_pass_megakernel`` and
    ``material_grads`` in Pallas interpret mode: the key split into k1, k2
    as the JAX step does, the cross-estimator's cotangents of each render
    through ``material_grads`` with that render's key (as the
    ``make_diff_renderer`` VJP does; JAX's jitted step is not run). The port
    takes ``seed_from_key(k1)`` and ``seed_from_key(k2)``. Bars: the loss to
    rtol 1e-5, the gradient within a relative L2 gap of 1e-3; the same for
    the sphere centres and radii (``param_spec=("sphere_transform",
    "sphere_radius")``) against ``geometry_grads`` of the same cotangents;
  * engine ``mega-fwd``'s gradient against central differences of the
    port's own loss with the same seeds (the pattern of
    ``test_inverse_mega_fwd_grads_match_fd``, rtol 0.05, atol 1e-5);
  * a mesh that is not a ``parallel.render.Mesh`` raises a TypeError naming
    it (the mesh itself: ``tests/test_torch_parallel.py``); engine
    ``mega-fwd`` refuses the boundary terms, engine
    ``mega`` a parameter K3/K4 do not take; on engines ``mega`` and ``jax``
    the boundary terms leave the loss's bits and add their gradient;
  * engine ``jax`` (the budget engine): ``render_loss`` and its gradient
    against kajo_tpu's ``render_loss`` under ``jax.jit``, the key split into
    k1, k2 and the port given ``seed_from_key`` of each (bars: the loss to
    rtol 1e-5, relative L2 gap <= 1e-3 per tensor); the IOR's gradient,
    non-zero at 32x24 through the glass ball, against kajo_tpu's at the same
    bars (its side in the SSE4.2 subprocess of ``tests/_jax_grad_ref.py``);
    a step's gradient is ``render_loss``'s; ``auto`` takes it on the CPU;
    and two 5-step fits at 16x16, the cheap versions of
    ``tests/test_diff.py``'s albedo recovery and ``tests/test_edges.py``'s
    cast-shadow recovery (the long fits run on the card, ``chip_smoke.py``
    phase 19);
  * ``python -m kajo_tpu_torch.inverse_rendering --device cpu`` at a tiny
    size, every engine.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from jax_goldens import replayed
from torch_port import jax_grad_scene, jax_kernel_reference, rel_l2, to_port

from kajo_tpu_torch import inverse_rendering
from kajo_tpu_torch.diff import inverse
from kajo_tpu_torch.models.integrator import RenderConfig
from kajo_tpu_torch.ops import megakernel, megakernel_grad
from kajo_tpu_torch.ops.megakernel import render_pass_megakernel
from kajo_tpu_torch.ops.rng import CounterKey, pass_seed
from kajo_tpu_torch.scene.testscene import build_test_scene

W, H, SPP = 8, 6, 4
KEY = 4
CFG = dict(max_depth=3)
CLIP = 1.0


def _scene(name="caustics.json", w=W, h=H):
    return to_port(jax_grad_scene(name, w / h))


def _target(scene, w=W, h=H):
    """A render of ``scene`` with its planes' albedos moved, at 16 spp."""
    diffuse = scene.materials.diffuse.clone()
    diffuse[: scene.num_planes, :3] *= torch.tensor([1.3, 0.8, 1.1])
    moved = inverse.apply_params(scene, {"diffuse": diffuse})
    return render_pass_megakernel(moved, 77, w, h, 16, RenderConfig(**CFG))


@pytest.mark.parametrize("spec", [inverse.DEFAULT_PARAM_SPEC, ("background", "emission", "specular_exponent")])
def test_extract_apply_round_trip(spec):
    scene = _scene()
    params = inverse.extract_params(scene, spec)
    assert list(params) == list(spec) and all(p.dtype == torch.float32 for p in params.values())
    same = inverse.apply_params(scene, params)
    for name in spec:
        assert torch.equal(megakernel_grad.leaf(same, name), megakernel_grad.leaf(scene, name))
    moved = {k: v + 1.0 for k, v in params.items()}
    other = inverse.apply_params(scene, moved)
    for name in spec:
        assert torch.equal(megakernel_grad.leaf(other, name), moved[name])
        assert torch.equal(megakernel_grad.leaf(scene, name), params[name])  # the scene is not changed
    assert other.num_objects == scene.num_objects and other.light_indices == scene.light_indices


@pytest.mark.parametrize("decay_steps", [0, 12])
def test_adam_schedule_matches_optax(decay_steps):
    import jax.numpy as jnp
    import optax

    rng = np.random.default_rng(1)
    grads = rng.normal(size=(15, 5, 3)).astype(np.float32) * np.float32(0.3)
    start = rng.normal(size=(5, 3)).astype(np.float32)
    lr = 2e-2
    tx = optax.adam(optax.cosine_decay_schedule(lr, decay_steps, 0.1) if decay_steps else lr)
    p_jax = jnp.asarray(start)
    state = tx.init(p_jax)
    params = {"x": torch.tensor(start)}
    opt, sched = inverse.make_adam(params, lr, decay_steps)
    assert (sched is None) == (decay_steps == 0)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, p_jax)
        p_jax = optax.apply_updates(p_jax, upd)
        params["x"].grad = torch.tensor(g)
        opt.step()
        if sched is not None:
            sched.step()
        np.testing.assert_allclose(params["x"].detach().numpy(), np.asarray(p_jax), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    target = _target(_scene()).numpy()
    ref = jax_kernel_reference(
        tmp_path_factory.mktemp("jax_loss"), "loss", {"caustics": ("caustics.json", CFG)}, W, H, SPP, KEY,
        {"target": target}, target="target", loss_clip=CLIP, geometry=True,
    )
    return target, ref


def test_mega_loss_and_grad_match_jax(reference):
    target, ref = reference
    scene = _scene()
    inv = inverse.InverseRenderer(
        scene, torch.tensor(target), W, H, spp=SPP, config=RenderConfig(**CFG), param_spec=("diffuse",),
        engine="mega", loss_clip=CLIP,
    )
    seed1, seed2 = (int(s) for s in ref["caustics/seeds"])
    loss, grads = inv.loss_and_grad(inv.params, seed1, seed2)
    assert megakernel.kernel_launches == 0 and megakernel_grad.kernel_launches == 0
    np.testing.assert_allclose(float(loss), float(ref["caustics/loss"]), rtol=1e-5)
    got = grads["diffuse"].numpy()
    assert got.shape == (scene.num_objects, 4) and np.isfinite(got).all() and (got[:, 3] == 0).all()
    gap = rel_l2(got[:, :3], ref["caustics/diffuse"])
    print(f"loss {float(loss):.6g} (JAX {float(ref['caustics/loss']):.6g}); diffuse gradient relative L2 gap {gap:.3e}")
    assert gap <= 1e-3


def test_mega_geometry_grad_matches_jax(reference):
    """The same step with ``param_spec=("sphere_transform",
    "sphere_radius")``: the backward's K4 gradients, put into the
    translation column and the radii, against kajo_tpu's ``geometry_grads``
    of the same cross-estimator cotangents and keys. Bar: relative L2 gap
    <= 1e-3 for the centres and the radii; the rest of the transform 0."""
    target, ref = reference
    scene = _scene()
    inv = inverse.InverseRenderer(
        scene, torch.tensor(target), W, H, spp=SPP, config=RenderConfig(**CFG),
        param_spec=("sphere_transform", "sphere_radius"), engine="mega", loss_clip=CLIP,
    )
    seed1, seed2 = (int(s) for s in ref["caustics/seeds"])
    loss, grads = inv.loss_and_grad(inv.params, seed1, seed2)
    np.testing.assert_allclose(float(loss), float(ref["caustics/loss"]), rtol=1e-5)
    st, radius = grads["sphere_transform"].numpy(), grads["sphere_radius"].numpy()
    assert np.isfinite(st).all() and np.isfinite(radius).all()
    rest = st.copy()
    rest[:, :3, 3] = 0.0
    assert not rest.any()
    for got, want in ((st[:, :3, 3], ref["caustics/center"]), (radius, ref["caustics/radius"])):
        gap = rel_l2(got, want)
        print(f"geometry gradient relative L2 gap {gap:.3e}, max |JAX| {np.abs(want).max():.4g}")
        assert np.abs(want).max() > 0 and gap <= 1e-3


def test_mega_fwd_grads_match_fd():
    """On the entry point's scene (``build_test_scene``), 16x12: the light's
    x and y and the red sphere's z. (On caustics the light's HDR pixels,
    unclipped, leave the float32 loss too coarse for a difference.)"""
    scene = build_test_scene(16 / 12, device="cpu")
    target = _target(scene, 16, 12)
    cfg = RenderConfig(**CFG)
    light, red = scene.light_indices[0], 1
    picks = [(light, 0), (light, 1), (red, 2)]
    mask = torch.zeros(scene.sphere_transform.shape, dtype=torch.bool)
    for i, r in picks:
        mask[i, r, 3] = True
    inv = inverse.InverseRenderer(
        scene, target, 16, 12, spp=SPP, config=cfg, param_spec=("sphere_transform",), engine="mega-fwd",
        param_mask={"sphere_transform": mask},
    )
    _, grads = inv.loss_and_grad(inv.params, 21, 22)
    g = grads["sphere_transform"]
    assert int(torch.count_nonzero(g)) == len(picks) and megakernel.jvp_launches == 0

    def loss_of(st):
        s = inverse.apply_params(scene, {"sphere_transform": st})
        i1, i2 = (render_pass_megakernel(s, seed, 16, 12, SPP, cfg) for seed in (21, 22))
        return float(inverse.cross_loss(i1, i2, target))

    h = 3e-4
    for i, r in picks:
        plus, minus = scene.sphere_transform.clone(), scene.sphere_transform.clone()
        plus[i, r, 3] += h
        minus[i, r, 3] -= h
        fd = (loss_of(plus) - loss_of(minus)) / (2 * h)
        assert abs(fd) > 1e-4
        np.testing.assert_allclose(float(g[i, r, 3]), fd, rtol=0.05, atol=1e-5)


@pytest.mark.parametrize(
    "kw,error,match",
    [
        (dict(engine="mega-fwd", edge_gradients=True), ValueError, "mega-fwd takes no boundary terms"),
        (dict(engine="mega-fwd", shadow_edges=True), ValueError, "mega-fwd takes no boundary terms"),
        (dict(mesh=object()), TypeError, "mesh must be a kajo_tpu_torch.parallel.render.Mesh.*not object"),
        (dict(engine="mega", param_spec=("refractive_index",)), ValueError, r"refractive_index.*need engine jax"),
    ],
    ids=["edges", "shadow-edges", "mesh", "mega-ior"],
)
def test_not_ported_raises(kw, error, match):
    """What the inverse renderer refuses, each with its own error: a mesh
    that is not a ``parallel.render.Mesh`` (the mesh is ported; this case,
    which asserted the NotImplementedError of the unported mesh, keeps its
    id and now asserts the TypeError naming the type); the boundary terms
    on engine mega-fwd (the JAX package ignores them there); a parameter K3
    and K4 do not differentiate on engine mega, naming engine jax."""
    scene = _scene()
    with pytest.raises(error, match=match):
        inverse.InverseRenderer(scene, torch.zeros((H, W, 4)), W, H, **kw)


@pytest.mark.parametrize("flag", ["edge_gradients", "shadow_edges"])
def test_boundary_terms_run_on_mega_and_leave_the_loss(flag):
    """On engine mega a boundary term adds nothing to the loss, bit for bit,
    and adds its gradient to the spheres' translations; a step without it
    keeps its seeds pass_seed(seed, 2i), pass_seed(seed, 2i + 1); a loss
    with the term and no edge key raises."""
    scene = _scene()
    target = _target(scene)
    kw = dict(spp=SPP, config=RenderConfig(**CFG), param_spec=("sphere_transform",), engine="mega", seed=5)
    plain = inverse.InverseRenderer(scene, target, W, H, **kw)
    edged = inverse.InverseRenderer(scene, target, W, H, **kw, **{flag: True}, n_edge=64, n_shadow_edge=2)
    seed1, seed2 = pass_seed(5, 0), pass_seed(5, 1)
    loss0, g0 = plain.loss_and_grad(plain.params, seed1, seed2)
    loss1, g1 = edged.loss_and_grad(edged.params, seed1, seed2, CounterKey(5).fold_in(0))
    with pytest.raises(ValueError, match="edge_key"):
        edged.loss_and_grad(edged.params, seed1, seed2)
    assert torch.equal(loss0, loss1)
    g0, g1 = g0["sphere_transform"], g1["sphere_transform"]
    assert torch.isfinite(g1).all() and not torch.equal(g0[:, :3, 3], g1[:, :3, 3])
    rest0, rest1 = g0.clone(), g1.clone()
    rest0[:, :3, 3] = rest1[:, :3, 3] = 0
    assert torch.equal(rest0, rest1)
    assert plain.step() == float(loss0) and edged.step() == float(loss1)


def test_mega_fwd_direction_cap():
    scene = _scene()
    with pytest.raises(ValueError, match="param_mask"):
        inverse.InverseRenderer(
            scene, torch.zeros((H, W, 4)), W, H, engine="mega-fwd", param_spec=("diffuse", "specular")
        )


@pytest.mark.parametrize("engine", ["mega", "mega-fwd", "jax"])
def test_entry_point_on_the_cpu(engine, tmp_path):
    summary = tmp_path / "run.json"
    rc = inverse_rendering.main(
        ["--device", "cpu", "--engine", engine, "-w", "8", "-h", "6", "--spp", "1", "--depth", "2", "--steps", "2",
         "--target-spp", "4", "--print-every", "1", "--out-prefix", str(tmp_path / "x"), "--summary", str(summary)]
    )
    assert rc == 0
    rec = json.loads(summary.read_text())
    assert rec["engine"] == engine and len(rec["losses"]) == 2 and np.isfinite(rec["losses"]).all()
    assert all((tmp_path / f"x_{k}.png").stat().st_size > 0 for k in ("target", "start", "recovered"))


# engine jax: the budget engine, which also differentiates the material
# fields K3/K4 do not take (caustics has a glass ball and Phong surfaces;
# transparency reaches the render only through the detached branch
# probabilities, so its gradient is 0 in both packages)
JAX_SPEC = ("sphere_transform", "sphere_radius", "diffuse", "specular_exponent", "refractive_index", "transparency")


@replayed
def kajo_render_loss(js, target, key, spec, w, h, spp, cfg, clip):
    """kajo_tpu's render_loss and its gradient under one jit, with its key's
    two halves as u32 seeds."""
    from kajo_tpu.diff.inverse import extract_params as jax_extract_params
    from kajo_tpu.diff.inverse import render_loss
    from kajo_tpu.models.integrator import RenderConfig as JaxRenderConfig
    from kajo_tpu.ops.rng import seed_from_key

    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: render_loss(p, js, target, key, w, h, spp, JaxRenderConfig(**cfg), loss_clip=clip)
    ))(jax_extract_params(js, spec))
    seeds = np.array([seed_from_key(k) for k in jax.random.split(key)], np.uint32)
    return dict({f"grad/{k}": v for k, v in grads.items()}, loss=loss, seeds=seeds)


@pytest.fixture(scope="module")
def jax_render_loss():
    """kajo_tpu's render_loss and its gradient on caustics at 8x6, with its
    key's two halves as u32 seeds; and the port's."""
    js = jax_grad_scene("caustics.json", W / H)
    target = _target(to_port(js)).numpy()
    ref = kajo_render_loss(js, target, jax.random.PRNGKey(8), JAX_SPEC, W, H, SPP, CFG, CLIP)
    seeds = tuple(int(s) for s in ref["seeds"])
    scene = _scene()
    leaves = {k: v.requires_grad_(True) for k, v in inverse.extract_params(scene, JAX_SPEC).items()}
    loss = inverse.render_loss(leaves, scene, torch.tensor(target), *seeds, W, H, SPP, RenderConfig(**CFG),
                               loss_clip=CLIP)
    got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    got = {k: torch.zeros_like(leaves[k]) if g is None else g for k, g in zip(JAX_SPEC, got)}
    return target, seeds, (loss.detach(), got), (float(ref["loss"]), {k: ref[f"grad/{k}"] for k in JAX_SPEC})


def _jax_engine(target, **kw):
    return inverse.InverseRenderer(_scene(), torch.tensor(target), W, H, spp=SPP, config=RenderConfig(**CFG),
                                   param_spec=JAX_SPEC, engine="jax", loss_clip=CLIP, **kw)


@pytest.mark.parametrize("name", JAX_SPEC)
def test_render_loss_matches_jax(jax_render_loss, name):
    _, _, (loss, got), (want_loss, want) = jax_render_loss
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    g = got[name].numpy()
    gap = rel_l2(g, want[name])
    print(f"render_loss {name}: relative L2 gap {gap:.3e}, max |JAX| {np.abs(want[name]).max():.4g}")
    assert g.shape == want[name].shape and np.isfinite(g).all()
    # at 8x6 and 4 spp no path leaves the glass ball for a surface it lights
    # within the depth: the IOR's gradient is 0 in both, as transparency's
    if name in ("refractive_index", "transparency"):
        assert not g.any() and not want[name].any()
    else:
        assert np.abs(want[name]).max() > 0 and gap <= 1e-3


IOR_W, IOR_H = 32, 24


@pytest.fixture(scope="module")
def jax_ior_loss(tmp_path_factory):
    """render_loss's gradient with respect to the IOR in both packages, on
    caustics at 32x24, 4 spp, depth 3: at this size paths refract through
    the glass ball onto a surface that NEE lights within the depth, so
    kajo_tpu's gradient is non-zero (at 8x6 it is 0, see above). A lane
    there crosses a branch when XLA fuses multiply-adds, so kajo_tpu's side
    runs in the subprocess of ``tests/_jax_grad_ref.py`` (SSE4.2)."""
    target = _target(_scene(w=IOR_W, h=IOR_H), IOR_W, IOR_H).numpy()
    ref = jax_kernel_reference(
        tmp_path_factory.mktemp("jax_ior"), "render_loss", {"caustics": ("caustics.json", CFG)}, IOR_W, IOR_H, SPP,
        3, {"target": target}, target="target", loss_clip=CLIP, params=["refractive_index"],
    )
    scene = _scene(w=IOR_W, h=IOR_H)
    ior = scene.materials.refractive_index.clone().requires_grad_(True)
    loss = inverse.render_loss({"refractive_index": ior}, scene, torch.tensor(target),
                               *(int(s) for s in ref["caustics/seeds"]), IOR_W, IOR_H, SPP, RenderConfig(**CFG),
                               loss_clip=CLIP)
    (got,) = torch.autograd.grad(loss, [ior])
    return (float(loss), got.numpy()), (float(ref["caustics/loss"]), ref["caustics/refractive_index"])


def test_render_loss_ior_gradient_matches_jax(jax_ior_loss):
    """A gradient through refraction: the glass ball's IOR gets a non-zero
    gradient in kajo_tpu, and the port's matches it."""
    (loss, got), (want_loss, want) = jax_ior_loss
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    gap = rel_l2(got, want)
    print(f"render_loss refractive_index at {IOR_W}x{IOR_H}: relative L2 gap {gap:.3e}, JAX {want}, port {got}")
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(want).max() > 0 and gap <= 1e-3


def test_render_loss_refuses_a_mesh():
    """render_loss refuses a mesh that is not a ``parallel.render.Mesh`` with
    a TypeError naming it. (Before the mesh was ported, this test asserted
    the NotImplementedError of any mesh; a real mesh is held in
    tests/test_torch_parallel.py.)"""
    scene = _scene()
    with pytest.raises(TypeError, match="mesh must be a kajo_tpu_torch.parallel.render.Mesh.*not object"):
        inverse.render_loss(inverse.extract_params(scene), scene, torch.zeros((H, W, 4)), 1, 2, W, H, SPP,
                            mesh=object())


def test_jax_engine_step_is_render_loss(jax_render_loss):
    """A step of engine jax takes render_loss's loss and gradient, bit for
    bit, then moves every optimised tensor it has a gradient for."""
    target, (seed1, seed2), (want_loss, want), _ = jax_render_loss
    inv = _jax_engine(target)
    loss, grads = inv.loss_and_grad(inv.params, seed1, seed2)
    assert torch.equal(loss, want_loss)
    assert all(torch.equal(grads[k], want[k]) for k in JAX_SPEC)
    before = {k: v.detach().clone() for k, v in inv.params.items()}
    assert inv.step(seed1, seed2) == float(loss)
    for k in JAX_SPEC:
        assert torch.equal(before[k], inv.params[k].detach()) == (not grads[k].any()), k


@pytest.mark.parametrize("kw", [{}, dict(edge_gradients=True)], ids=["plain", "edges"])
def test_auto_takes_jax_on_the_cpu(kw):
    inv = inverse.InverseRenderer(_scene(), torch.zeros((H, W, 4)), W, H, param_spec=("diffuse",), **kw)
    assert inv.engine == "jax"


@pytest.mark.parametrize("flag", ["edge_gradients", "shadow_edges"])
def test_boundary_terms_run_on_jax_and_leave_the_loss(flag):
    """As on engine mega: the term adds nothing to the loss, bit for bit, and
    adds its gradient to the spheres' translations only."""
    scene = _scene()
    target = _target(scene)
    kw = dict(spp=SPP, config=RenderConfig(**CFG), param_spec=("sphere_transform",), engine="jax", seed=5)
    plain = inverse.InverseRenderer(scene, target, W, H, **kw)
    edged = inverse.InverseRenderer(scene, target, W, H, **kw, **{flag: True}, n_edge=64, n_shadow_edge=2)
    seed1, seed2 = pass_seed(5, 0), pass_seed(5, 1)
    loss0, g0 = plain.loss_and_grad(plain.params, seed1, seed2)
    loss1, g1 = edged.loss_and_grad(edged.params, seed1, seed2, CounterKey(5).fold_in(0))
    assert torch.equal(loss0, loss1)
    g0, g1 = g0["sphere_transform"], g1["sphere_transform"]
    assert torch.isfinite(g1).all() and not torch.equal(g0[:, :3, 3], g1[:, :3, 3])
    rest0, rest1 = g0.clone(), g1.clone()
    rest0[:, :3, 3] = rest1[:, :3, 3] = 0
    assert torch.equal(rest0, rest1)


FIT = 16  # the short fits' image size


def test_jax_fit_recovers_albedo():
    """tests/test_diff.py's albedo recovery, 5 steps: the albedo moves from
    (0.3, 0.6, 0.6) toward the truth (0.7, 0.4, 0.2). (Five losses say
    nothing here: the emitter's silhouette, unclipped, swings the
    cross-estimator by ~0.2 from one pair of seeds to the next.)"""
    from kajo_tpu_torch.models.integrator import render_pass
    from kajo_tpu_torch.scene.types import scene_from_numpy

    from test_diff import _two_sphere_scene

    scene = scene_from_numpy(dataclasses.asdict(jax.tree.map(np.asarray, _two_sphere_scene())), "cpu")
    cfg = RenderConfig(max_depth=2)
    target = render_pass(scene, 42, FIT, FIT, 4, cfg)
    diffuse = scene.materials.diffuse.clone()
    diffuse[0, :3] = torch.tensor([0.3, 0.6, 0.6])
    inv = inverse.InverseRenderer(inverse.apply_params(scene, {"diffuse": diffuse}), target, FIT, FIT, spp=4,
                                  config=cfg, learning_rate=1e-1, param_spec=("diffuse",), decay_steps=250, seed=7)
    truth = torch.tensor([0.7, 0.4, 0.2])
    err0 = float((diffuse[0, :3] - truth).abs().max())
    losses = [inv.step() for _ in range(5)]
    err = float((inv.params["diffuse"].detach()[0, :3] - truth).abs().max())
    print(f"losses {losses}; albedo error {err0:.3f} -> {err:.3f}")
    assert inv.engine == "jax" and np.isfinite(losses).all() and err < err0 - 0.25


def test_jax_fit_recovers_cast_shadow():
    """tests/test_edges.py's cast-shadow recovery (shadow_edges, engine
    auto -> jax), 5 steps at 16x16, 4 spp: the occluder's x moves from 2.3
    toward its true 2.0 by at least 0.1."""
    from kajo_tpu_torch.models.integrator import render_image
    from kajo_tpu_torch.scene.testscene import build_shadow_scene

    cfg = RenderConfig(max_depth=1)
    target = render_image(build_shadow_scene(2.0, "cpu"), FIT, FIT, 16, 7, passes=2, config=cfg)
    inv = inverse.InverseRenderer(build_shadow_scene(2.3, "cpu"), target, FIT, FIT, spp=4, config=cfg,
                                  param_spec=("sphere_transform",), shadow_edges=True, n_shadow_edge=8, n_edge=64,
                                  learning_rate=3e-2, seed=9)
    errs = []
    for _ in range(5):
        inv.step()
        errs.append(abs(float(inv.params["sphere_transform"].detach()[0, 0, 3]) - 2.0))
    print(f"|x - 2| by step: {errs}")
    assert inv.engine == "jax" and errs[-1] < 0.2
