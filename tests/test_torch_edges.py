"""The port's boundary terms (``kajo_tpu_torch.diff.edges``) against
kajo_tpu's, on the CPU.

  * ``silhouette_loss_grads`` on the flat-lit sphere of
    ``tests/test_edges.py`` (``_edge_scene``, moved off centre) and
    ``shadow_silhouette_grads`` on its out-of-frame occluder
    (``_shadow_scene``), at 32x32 with ``n_edge`` 64 and 4, under a ramp
    and a random cotangent: the port draws the JAX package's uniforms for
    the same key (``torch_port.JaxKey``); bar: a relative L2 gap of 1e-3 on
    each output (measured 1e-7 to 3.3e-5: the probes' radiance and the
    shadow rays' visibility agree, and the edge geometry rounds in the last
    bits);
  * the port's probe scenes (``scene/testscene.py``) hold the arrays of
    ``_edge_scene`` and ``_shadow_scene``;
  * ``make_silhouette_term``: its forward is exactly zero, and its backward
    for a given cotangent equals the two functions' gradients (the shadow
    term under ``key.fold_in(1)``), routed into the translation column of
    ``sphere_transform`` and into ``sphere_radius``;
  * the port's own x-gradient against central differences of its parity
    renders (the pattern of ``tests/test_edges.py::
    test_position_gradient_matches_fd``, rtol 0.15);
  * engine ``mega`` with ``edge_gradients`` (the plain K1/K3/K4 on the CPU)
    lowers the flat-lit sphere's x error from 0.6 within 10 steps at 16x16:
    the small version of ``test_inverse_silhouette_recovery_mega_engine``;
  * ``python -m kajo_tpu_torch.silhouette_recovery --device cpu`` at 16x16 (its
    ``SIZE`` and ``SPP`` patched down).

The JAX functions run under ``jax.jit``."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_goldens import replayed
from test_edges import _edge_scene, _shadow_scene
from torch_port import JaxKey, rel_l2, to_port

from kajo_tpu.diff import edges as jax_edges
from kajo_tpu.models.integrator import RenderConfig as JaxRenderConfig
from kajo_tpu_torch import silhouette_recovery
from kajo_tpu_torch.diff import edges
from kajo_tpu_torch.diff.inverse import InverseRenderer, apply_params
from kajo_tpu_torch.models.integrator import RenderConfig, render_image
from kajo_tpu_torch.ops.rng import CounterKey
from kajo_tpu_torch.scene.testscene import build_shadow_scene, build_silhouette_scene
from kajo_tpu_torch.scene.types import map_tensors

W = H = 32
CFG, SHADOW_CFG = dict(max_depth=2), dict(max_depth=1)


@pytest.mark.parametrize("kind", ["silhouette", "shadow"])
def test_probe_scenes_equal_the_jax_tests(kind):
    """The port's functions for the two probe scenes (chip_smoke.py phase 18
    runs them) hold the arrays of tests/test_edges.py's scenes."""
    got, want = ((build_silhouette_scene(0.3, -0.2, device="cpu"), to_port(_edge_scene(0.3, -0.2)))
                 if kind == "silhouette" else (build_shadow_scene(2.3, device="cpu"), to_port(_shadow_scene(ox=2.3))))
    map_tensors(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0), got, want)
    assert (got.light_indices, got.rigid_spheres) == (want.light_indices, want.rigid_spheres)


def _cotangent(kind, w=W, h=H):
    if kind == "ramp":
        return np.broadcast_to((np.arange(w, dtype=np.float32) / w)[None, :, None], (h, w, 3)).copy()
    return np.random.default_rng(4).normal(size=(h, w, 3)).astype(np.float32)


@replayed
def kajo_boundary_grads(kind, js, key, c, w, h, cfg, n_edge):
    fn = jax_edges.silhouette_loss_grads if kind == "silhouette" else jax_edges.shadow_silhouette_grads
    jax_fn = jax.jit(fn, static_argnames=("width", "height", "config", "n_edge"))
    want_c, want_r = jax_fn(js, key, jnp.asarray(c), width=w, height=h, config=JaxRenderConfig(**cfg), n_edge=n_edge)
    return {"center": want_c, "radius": want_r}


@pytest.mark.parametrize("cot", ["ramp", "random"])
@pytest.mark.parametrize("kind", ["silhouette", "shadow"])
def test_boundary_grads_match_jax(kind, cot):
    c = _cotangent(cot)
    if kind == "silhouette":
        js, cfg, n_edge, fn = _edge_scene(0.3, -0.2), CFG, 64, edges.silhouette_loss_grads
    else:
        js, cfg, n_edge, fn = _shadow_scene(), SHADOW_CFG, 4, edges.shadow_silhouette_grads
    want = kajo_boundary_grads(kind, js, jax.random.PRNGKey(1), c, W, H, cfg, n_edge)
    want_c, want_r = want["center"], want["radius"]
    got_c, got_r = fn(to_port(js), JaxKey(1), torch.from_numpy(c), W, H, RenderConfig(**cfg), n_edge)
    gaps = rel_l2(got_c, want_c), rel_l2(got_r, want_r)
    print(f"{kind} {cot}: centre {got_c.numpy().ravel()} vs {np.asarray(want_c).ravel()}, radius "
          f"{got_r.numpy()} vs {np.asarray(want_r)}; relative L2 gaps {gaps[0]:.2e}, {gaps[1]:.2e}")
    assert np.linalg.norm(np.asarray(want_c)) > 1.0  # the term is not trivially zero
    assert max(gaps) <= 1e-3


def test_silhouette_term_forward_is_zero_and_backward_is_the_boundary_grads():
    scene = to_port(_shadow_scene())
    cot = torch.from_numpy(_cotangent("random"))
    cfg = RenderConfig(**SHADOW_CFG)
    term = edges.make_silhouette_term(W, H, cfg, n_edge=32, shadow_edges=True, n_shadow_edge=4)
    st = scene.sphere_transform.clone().requires_grad_(True)
    rad = scene.sphere_radius.clone().requires_grad_(True)
    key = CounterKey(3)
    with torch.enable_grad():
        img = term(apply_params(scene, {"sphere_transform": st, "sphere_radius": rad}), key)
        assert img.shape == (H, W, 4) and bool((img == 0).all())
        g_st, g_r = torch.autograd.grad(torch.sum(cot * img[..., :3]), (st, rad))
    gc, gr = edges.silhouette_loss_grads(scene, key, cot, W, H, cfg, 32)
    gc2, gr2 = edges.shadow_silhouette_grads(scene, key.fold_in(1), cot, W, H, cfg, 4)
    assert float(gc2.abs().max()) > 0  # the shadow term takes part
    torch.testing.assert_close(g_st[:, :3, 3], gc + gc2, rtol=1e-6, atol=0)
    torch.testing.assert_close(g_r, gr + gr2, rtol=1e-6, atol=0)
    rest = g_st.clone()
    rest[:, :3, 3] = 0
    assert not bool(rest.any())


def _parity_loss(scene, cot, spp=64, passes=6):
    img = render_image(scene, W, H, spp, 0, passes=passes, config=RenderConfig(**CFG))
    return float(torch.sum(cot * img[..., :3]))


def test_position_gradient_matches_fd():
    cot = torch.from_numpy(_cotangent("ramp"))
    gc, _ = edges.silhouette_loss_grads(to_port(_edge_scene()), CounterKey(1), cot, W, H, RenderConfig(**CFG),
                                        n_edge=2048)
    h = 0.05
    fd = (_parity_loss(to_port(_edge_scene(cx=h)), cot) - _parity_loss(to_port(_edge_scene(cx=-h)), cot)) / (2 * h)
    print(f"x-gradient {float(gc[0, 0]):.3f}, central difference {fd:.3f}")
    assert abs(fd) > 1.0  # the signal exists, and only the silhouette carries it
    np.testing.assert_allclose(float(gc[0, 0]), fd, rtol=0.15)
    assert abs(float(gc[0, 0])) > 5 * abs(float(gc[0, 1]))


def test_mega_engine_with_edge_gradients_lowers_the_position_error():
    w = h = 16
    cfg = RenderConfig(**CFG)
    target = render_image(to_port(_edge_scene(cx=0.0)), w, h, 16, 7, passes=2, config=cfg)
    inv = InverseRenderer(to_port(_edge_scene(cx=0.6)), target, w, h, spp=4, config=cfg,
                          param_spec=("sphere_transform",), edge_gradients=True, n_edge=256, learning_rate=5e-2,
                          engine="mega", seed=9)
    errors = [0.6]
    for _ in range(10):
        inv.step()
        errors.append(abs(float(inv.params["sphere_transform"].detach()[0, 0, 3])))
    print("x error per step: " + " ".join(f"{e:.4f}" for e in errors))
    assert errors[-1] < 0.5 * errors[0]


def test_silhouette_recovery_entry_point_on_the_cpu(tmp_path, monkeypatch):
    """The example's own size is 64x64 at 16 spp; the CPU run shrinks it
    through the module's constants."""
    monkeypatch.setattr(silhouette_recovery, "SIZE", 16)
    monkeypatch.setattr(silhouette_recovery, "SPP", 4)
    summary = tmp_path / "run.json"
    rc = silhouette_recovery.main(["--device", "cpu", "--steps", "3",
                                   "--out-prefix", str(tmp_path / "s"), "--summary", str(summary)])
    assert rc == 0
    rec = json.loads(summary.read_text())
    assert rec["engine"] == "mega" and len(rec["losses"]) == 3 and np.isfinite(rec["losses"]).all()
    (s0, e0), (s3, e3) = rec["errors"]
    assert (s0, s3) == (0, 3) and e3 < e0
    assert all((tmp_path / f"s_{k}.png").stat().st_size > 0 for k in ("target", "start", "recovered"))
