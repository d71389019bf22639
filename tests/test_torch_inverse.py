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
  * what is not ported raises NotImplementedError naming its ROADMAP item;
    engine ``mega-fwd`` refuses the boundary terms; on engine ``mega`` they
    leave the loss's bits and add their gradient;
  * ``python -m kajo_tpu_torch.inverse_rendering --device cpu`` at a tiny
    size, both engines.
"""

import json

import numpy as np
import pytest
import torch
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
        (dict(engine="jax"), NotImplementedError, "engine jax"),
        (dict(engine="auto"), NotImplementedError, "engine auto"),
        (dict(engine="mega-fwd", edge_gradients=True), ValueError, "mega-fwd takes no boundary terms"),
        (dict(engine="mega-fwd", shadow_edges=True), ValueError, "mega-fwd takes no boundary terms"),
        (dict(mesh=object()), NotImplementedError, "mesh"),
        (dict(engine="mega", param_spec=("refractive_index",)), NotImplementedError, "refractive_index"),
    ],
    ids=["engine-jax", "auto-on-cpu", "edges", "shadow-edges", "mesh", "mega-ior"],
)
def test_not_ported_raises(kw, error, match):
    """What is not ported raises NotImplementedError naming its ROADMAP
    item; the boundary terms, ported, are refused by engine mega-fwd alone
    (the JAX package ignores them there)."""
    scene = _scene()
    with pytest.raises(error, match=match) as err:
        inverse.InverseRenderer(scene, torch.zeros((H, W, 4)), W, H, **kw)
    if error is NotImplementedError:
        assert "ROADMAP Queue 1" in str(err.value)


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


@pytest.mark.parametrize("engine", ["mega", "mega-fwd"])
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
