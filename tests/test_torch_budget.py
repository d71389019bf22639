"""The port's differentiable budget engine (``models/wavefront.py``:
``render_pass_budget``, ``render_lanes_budget``, ``render_image_fast``) and
the streamed nearest hit's VJP (``ops/stream_trace.py``: ``nearest_vjp``)
against kajo_tpu's, on the CPU.

  * the budget pass's image against kajo_tpu's ``render_pass_budget``, same
    u32 seed (``seed_from_key``), on caustics, scaled.json and the two-light
    scene at 32x24, 4 spp, depth 2. Bars (the wavefront tests'): tone-mapped
    MAD <= 5e-4 and mean relative gap <= 1%;
  * on a dense scene, every pixel whose lane completed its samples equals
    ``render_pass_fast``'s bit for bit;
  * the gradient of a budget loss (mean of the image times a fixed random
    cotangent) with respect to the spheres' transforms and radii and the
    materials' diffuse, emission and specular exponent, on the two-sphere
    scene of ``tests/test_diff.py``, against ``jax.grad`` of kajo_tpu's under
    one ``jax.jit``. Bar: relative L2 gap <= 1e-3 per tensor (kajo_tpu
    detaches the roulette and lottery probabilities; a port that did not
    would fail it);
  * every sphere's gradient finite on ``build_test_scene``;
  * the finite-difference checks of ``tests/test_diff.py`` (albedo, emission,
    the light's position; the radius's gradient finite) on the port's budget
    engine, at their tolerances;
  * the VJP's backward against kajo_tpu's ``_nearest_bwd`` called directly on
    the same residuals (no Pallas kernel runs), rigid and general records;
  * the gradient with respect to every radius through the streamed trace
    (``STREAM_THRESHOLD`` lowered to 64) against the dense trace's, at
    ``tests/test_bigscene.py``'s configuration and bars;
  * ``render_image_fast`` against kajo_tpu's on caustics, pass p with the
    seed of ``fold_in(key, p)`` in both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_goldens import replayed
from test_diff import _two_sphere_scene
from torch_port import JaxKey, jax_scene, jax_two_light_scene, mean_rel, rel_l2, tm_mad, to_port

from kajo_tpu.diff.inverse import apply_params as jax_apply_params
from kajo_tpu.models.integrator import RenderConfig as JaxRenderConfig
from kajo_tpu.models.wavefront import render_image_fast as jax_render_image_fast
from kajo_tpu.models.wavefront import render_pass_budget as jax_render_pass_budget
from kajo_tpu.ops.rng import seed_from_key
from kajo_tpu_torch.diff.inverse import apply_params, extract_params
from kajo_tpu_torch.models import wavefront
from kajo_tpu_torch.models.integrator import RenderConfig
from kajo_tpu_torch.ops import geometry
from kajo_tpu_torch.ops import stream_trace as st
from kajo_tpu_torch.scene.procedural import random_spheres_scene

W, H, SPP = 32, 24, 4


@replayed
def kajo_budget_pass(js, key, w, h, spp, max_depth):
    return {"img": jax_render_pass_budget(js, key, w, h, spp, JaxRenderConfig(max_depth=max_depth))}


@pytest.mark.parametrize("name", ["caustics.json", "scaled.json", "two-light"], ids=["caustics", "scaled", "two-light"])
def test_budget_pass_matches_jax(name):
    js = jax_two_light_scene(W / H) if name == "two-light" else jax_scene(name, W / H)
    key = jax.random.PRNGKey(5)
    want = kajo_budget_pass(js, key, W, H, SPP, 2)["img"]
    got = wavefront.render_pass_budget(to_port(js), int(seed_from_key(key)), W, H, SPP, RenderConfig(max_depth=2))
    got = got.numpy()
    assert got.shape == (H, W, 4) and np.isfinite(got).all() and (got[..., 3] == 1).all()
    mad, rel = tm_mad(got, want), mean_rel(got, want)
    print(f"budget {name}: tone-mapped MAD {mad:.3e}, mean relative gap {rel:.3e}")
    assert mad <= 5e-4, mad
    assert rel <= 0.01, rel


def test_completed_pixels_equal_the_fast_pass():
    """One lane per pixel on a dense scene in both engines, the same body and
    seed: a lane that completed its samples within the budget holds the
    fast pass's sums; a short budget leaves some lanes incomplete."""
    scene = to_port(jax_scene("caustics.json", W / H))
    cfg = RenderConfig(max_depth=2)
    fast = wavefront.render_pass_fast(scene, 9, W, H, SPP, cfg).reshape(-1, 4)
    budget = wavefront.render_pass_budget(scene, 9, W, H, SPP, cfg).reshape(-1, 4)
    prep = geometry.prepare_scene(scene)
    lane = torch.arange(W * H)
    seed = torch.tensor(9)
    for iters, want_all in ((wavefront.BUDGET_ITERS_PER_SAMPLE * SPP, True), (SPP + 1, False)):
        _, completed = wavefront.render_lanes_budget(prep, lane, seed, W, H, SPP, 2, cfg, iters)
        done = completed == SPP
        print(f"{iters} iterations: {int(done.sum())} of {W * H} lanes completed")
        assert bool(done.all()) == want_all and bool(done.any())
    _, completed = wavefront.render_lanes_budget(prep, lane, seed, W, H, SPP, 2, cfg,
                                                   wavefront.BUDGET_ITERS_PER_SAMPLE * SPP)
    assert torch.equal(budget[completed == SPP], fast[completed == SPP])


GRAD_W = GRAD_H = 16
GRAD_SPEC = ("sphere_transform", "sphere_radius", "diffuse", "emission", "specular_exponent")


@replayed
def kajo_budget_grads(js, cot, key, spec, w, h):
    """kajo_tpu's budget loss mean(image * cot) and its gradients, under one jit."""

    def jax_loss(params):
        img = jax_render_pass_budget(jax_apply_params(js, params), key, w, h, 4, JaxRenderConfig(max_depth=2))
        return jnp.mean(img[..., :3] * cot)

    jp = {k: getattr(js, k) if hasattr(js, k) else getattr(js.materials, k) for k in spec}
    loss, grads = jax.jit(jax.value_and_grad(jax_loss))(jp)
    return dict({f"grad/{k}": v for k, v in grads.items()}, loss=loss)


@pytest.fixture(scope="module")
def budget_grads():
    """The budget loss's gradients in both packages, JAX's under one jit."""
    js = _two_sphere_scene()
    cot = np.random.default_rng(0).random((GRAD_H, GRAD_W, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = kajo_budget_grads(js, cot, key, GRAD_SPEC, GRAD_W, GRAD_H)
    want_loss, want = ref["loss"], {k: ref[f"grad/{k}"] for k in GRAD_SPEC}
    scene = to_port(js)
    leaves = {k: v.requires_grad_(True) for k, v in extract_params(scene, GRAD_SPEC).items()}
    img = wavefront.render_pass_budget(apply_params(scene, leaves), int(seed_from_key(key)), GRAD_W, GRAD_H, 4,
                                       RenderConfig(max_depth=2))
    loss = torch.mean(img[..., :3] * torch.from_numpy(cot))
    got = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    return float(loss), float(want_loss), got, {k: np.asarray(v) for k, v in want.items()}


@pytest.mark.parametrize("name", GRAD_SPEC)
def test_budget_grad_matches_jax(budget_grads, name):
    loss, want_loss, got, want = budget_grads
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    g = got[name].numpy()
    assert g.shape == want[name].shape and np.isfinite(g).all()
    gap = rel_l2(g, want[name])
    print(f"{name}: relative L2 gap {gap:.3e}, max |JAX| {np.abs(want[name]).max():.4g}")
    if name == "specular_exponent":  # the scene has no Phong surface: exactly 0 in both
        assert not g.any() and not want[name].any()
        return
    assert np.abs(want[name]).max() > 0 and gap <= 1e-3


def test_gradient_finite_on_the_test_scene():
    """Every radius and centre of ``build_test_scene`` gets a finite
    gradient (64x48, 4 spp, depth 3, seed 1): a ray whose discriminant on
    the light is exactly 0 made the root's backward 0 * inf = NaN in its
    radius while the root was that of a clamp (it is now the double-where
    ``safe_sqrt``, as kajo_tpu's)."""
    from kajo_tpu_torch.scene.testscene import build_test_scene

    scene = build_test_scene(64 / 48, "cpu")
    leaves = {k: v.requires_grad_(True) for k, v in extract_params(scene, ("sphere_transform", "sphere_radius")).items()}
    img = wavefront.render_pass_budget(apply_params(scene, leaves), 1, 64, 48, 4, RenderConfig(max_depth=3))
    for g in torch.autograd.grad(img[..., :3].mean(), list(leaves.values())):
        assert torch.isfinite(g).all() and g.abs().max() > 0


# tests/test_diff.py's finite-difference checks, on the port's budget engine
FD_CFG = RenderConfig(max_depth=2)


def _mean_rgb(scene, key_int):
    img = wavefront.render_pass_budget(scene, int(seed_from_key(jax.random.PRNGKey(key_int))), 24, 24, 4, FD_CFG)
    return torch.mean(img[..., :3])


def _fd_check(scene, set_value, x0, h, key_int, rtol, atol):
    x = torch.tensor(x0, requires_grad=True)
    (g,) = torch.autograd.grad(_mean_rgb(set_value(scene, x), key_int), [x])
    with torch.no_grad():
        fd = (_mean_rgb(set_value(scene, torch.tensor(x0 + h)), key_int)
              - _mean_rgb(set_value(scene, torch.tensor(x0 - h)), key_int)) / (2 * h)
    print(f"gradient {float(g):.6g}, central difference {float(fd):.6g}")
    np.testing.assert_allclose(float(g), float(fd), rtol=rtol, atol=atol)


def _with_material(field, row, cols):
    def set_value(scene, x):
        value = getattr(scene.materials, field).clone()
        value[row, cols] = x
        return apply_params(scene, {field: value})

    return set_value


def test_budget_grad_matches_fd_albedo():
    # the blue channel (not the largest): roulette and lottery probabilities stay put
    _fd_check(to_port(_two_sphere_scene()), _with_material("diffuse", 0, 2), 0.2, 1e-2, 0, 0.08, 1e-4)


def test_budget_grad_matches_fd_emission():
    _fd_check(to_port(_two_sphere_scene()), _with_material("emission", 1, slice(0, 3)), 30.0, 1e-1, 1, 0.05, 1e-6)


def test_budget_grad_matches_fd_light_position():
    def set_value(scene, dz):
        st_ = scene.sphere_transform.clone()
        st_[1, 2, 3] = st_[1, 2, 3] + dz
        return apply_params(scene, {"sphere_transform": st_})

    _fd_check(to_port(_two_sphere_scene()), set_value, 0.0, 5e-3, 2, 0.1, 5e-5)


def test_budget_grad_radius_finite():
    scene = to_port(_two_sphere_scene())
    r = scene.sphere_radius.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(_mean_rgb(apply_params(scene, {"sphere_radius": r}), 3), [r])
    assert torch.isfinite(g).all() and g[0] != 0


# the streamed nearest hit's VJP
def _scene_rays(jitter):
    """A 200-sphere field's prepared scene with its stream packing, and 256
    rays from the camera toward 64 of its spheres, 4 a sphere, aimed within
    half a radius of the centre (most hit, and a record gathers several
    rays' terms)."""
    scene = random_spheres_scene(200, seed=21, extent=15.0, n_lights=2, scale_jitter=jitter, device="cpu")
    prep = geometry.prepare_scene(scene)
    packed, boxes, perm, inv_perm, sboxes = st.build_stream_scene(prep)
    prep = dataclasses.replace(prep, stream_packed=packed, stream_boxes=boxes, stream_perm=perm,
                               stream_inv_perm=inv_perm, stream_sboxes=sboxes)
    rng = np.random.default_rng(2)
    which = torch.from_numpy(rng.choice(200, 64, replace=False)).repeat_interleave(4)
    radius = torch.sqrt(prep.sphere_radius2[which])[:, None]
    aim = prep.sphere_center[which] + radius * torch.from_numpy(rng.uniform(-0.5, 0.5, (256, 3)).astype(np.float32))
    o = prep.camera.origin.expand(256, 3).contiguous()
    d = aim - o
    return prep, o, d / torch.linalg.norm(d, dim=-1, keepdim=True)


@replayed
def kajo_nearest_bwd(rigid, o, d, packed, boxes, t, idx, gt):
    """kajo_tpu's VJP of the streamed nearest hit on these residuals."""
    from kajo_tpu.ops.pallas.stream_trace import _nearest_bwd

    res = tuple(jnp.asarray(x) for x in (o, d, packed, boxes, t, idx))
    return dict(zip(("o", "d", "t_max", "packed", "boxes"), _nearest_bwd(rigid, res, (jnp.asarray(gt), None))))


@pytest.mark.parametrize("jitter", [0.0, 0.5], ids=["rigid", "general"])
def test_nearest_vjp_matches_jax(jitter):
    prep, o, d = _scene_rays(jitter)
    bound = torch.full((o.shape[0],), st.BIG)
    t, idx = st.nearest_sphere_plain(prep.rigid, o, d, bound, prep.stream_packed, prep.stream_boxes)
    assert int((idx >= 0).sum()) > o.shape[0] // 2
    gt = torch.from_numpy(np.random.default_rng(1).normal(size=o.shape[0]).astype(np.float32))
    got = st.nearest_vjp(prep.rigid, o, d, prep.stream_packed, idx, gt)
    ref = kajo_nearest_bwd(prep.rigid, *(x.numpy() for x in (o, d, prep.stream_packed, prep.stream_boxes, t,
                                                               idx.to(torch.int32), gt)))
    go, gd, gtm, gpacked, gboxes = (ref[k] for k in ("o", "d", "t_max", "packed", "boxes"))
    assert not np.asarray(gtm).any() and not np.asarray(gboxes).any()
    for label, g, want in zip(("o", "d", "packed"), got, (go, gd, gpacked)):
        want = np.asarray(want)
        gap = rel_l2(g.numpy(), want)
        print(f"{'rigid' if prep.rigid else 'general'} {label}: relative L2 gap {gap:.3e}")
        assert g.shape == want.shape and np.isfinite(g.numpy()).all() and np.abs(want).max() > 0
        assert gap <= 1e-5


def test_streamed_gradient_matches_dense(monkeypatch):
    """jax.grad's streamed-against-dense check of tests/test_bigscene.py on
    the port: every radius's gradient through the budget engine, the
    camera, bounce and NEE traces through the streamed trace (its VJP; the
    rigid scene's shadow rays through the plain K6, without gradient),
    against the dense trace's autodiff. Bars: rtol 0.1 on the entries above
    1e-3 of the largest, cosine > 0.999."""
    scene = random_spheres_scene(200, seed=21, extent=15.0, n_lights=2, device="cpu")
    cfg = RenderConfig(max_depth=2)

    def grad():
        r = scene.sphere_radius.clone().requires_grad_(True)
        img = wavefront.render_pass_budget(apply_params(scene, {"sphere_radius": r}), 11, 12, 9, 4, cfg)
        return torch.autograd.grad(img[..., :3].mean(), [r])[0].numpy()

    g_dense = grad()
    monkeypatch.setattr(geometry, "STREAM_THRESHOLD", 64)
    assert geometry.prepare_scene(scene).stream_packed is not None
    g_stream = grad()
    assert np.isfinite(g_stream).all() and np.abs(g_dense).max() > 0
    big = np.abs(g_dense) > 1e-3 * np.abs(g_dense).max()
    np.testing.assert_allclose(g_stream[big], g_dense[big], rtol=0.1)
    cos = float((g_stream * g_dense).sum() / max(np.linalg.norm(g_stream) * np.linalg.norm(g_dense), 1e-30))
    print(f"{int(big.sum())} entries compared, cosine {cos:.6f}, largest relative gap "
          f"{np.abs(g_stream[big] / g_dense[big] - 1).max():.3e}")
    assert cos > 0.999, cos


@replayed
def kajo_image_fast(js, w, h, spp, key, passes, max_depth):
    config = JaxRenderConfig(max_depth=max_depth)
    return {"img": jax_render_image_fast(js, w, h, spp, key, passes=passes, config=config)}


def test_render_image_fast_matches_jax():
    js = jax_scene("caustics.json", W / H)
    key = jax.random.PRNGKey(6)
    want = kajo_image_fast(js, W, H, SPP, key, 2, 2)["img"]
    got = wavefront.render_image_fast(to_port(js), W, H, SPP, JaxKey(key), passes=2, config=RenderConfig(max_depth=2))
    got = got.numpy()
    mad, rel = tm_mad(got, want), mean_rel(got, want)
    print(f"render_image_fast caustics 2 passes: tone-mapped MAD {mad:.3e}, mean relative gap {rel:.3e}")
    assert np.isfinite(got).all() and mad <= 5e-4 and rel <= 0.01
