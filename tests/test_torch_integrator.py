"""The port's parity engine (``kajo_tpu_torch.models.integrator``) against
kajo_tpu's, on the CPU.

Both packages draw from the same ``jax.random`` key: the port through
``torch_port.JaxKey``, which hands it the JAX package's uniforms. So the two
trace the same paths, and what differs is float rounding: XLA's and
PyTorch's sines, cosines and fused products round differently in the last
bit, and Phong lobes raise a cosine to its exponent (300 and 400 on
caustics), which turns an ulp into ~1e-5 of a lane's radiance, and more
along a chain of glossy bounces. Measured at 16x12 and 32x24 lanes, depth
8: every lane within 2e-4·max(1, |x|) and 97.4-100% within 1e-5 (caustics
the lowest); a lane sent down another path by a coin flip on an ulp would
be off by O(1). The bars: at least 99.5% of lanes within 1e-3·max(1, |x|)
and at least 95% within 1e-5·max(1, |x|); each case prints both counts.

  * ``render_samples`` on the same rays (made with numpy, 16x12 lanes):
    caustics (rigid record), ``scaled.json`` (general transforms),
    ``build_test_scene`` under the parity, ``full_mis``,
    ``direct_lighting=False`` and ``gl_semantics`` configurations, and the
    two-light scene with ``one_light_nee``; ``max_depth`` 8 throughout;
  * ``render_pass`` and ``render_image`` at 16x12, 4 spp (the stratified
    coordinates): tone-mapped MAD <= 5e-4 and mean relative gap <= 1%, with
    the pixels that differ printed (the two packages' camera rays differ by
    up to ~6e-6 there: the camera basis's inverse and the ray arithmetic
    round differently, so a ray at a silhouette may take another object);
  * the port alone, as ``tests/test_integrator.py`` checks kajo_tpu: the
    exact 25/32 ratio of ``kajo_spp_quirk``, the background on a miss and
    in the empty scene, finite non-negative images, ``full_mis`` adding
    energy; and the C++ golden (caustics 32x24, 16 spp, 10 passes, the
    counter key of a u32 seed): MAD < 0.1, mean relative gap < 0.25;
  * the counter key: deterministic, and its streams differ under different
    fold and split paths.

The JAX functions run under ``jax.jit`` (one compilation per configuration
instead of one per operation)."""

import os

import jax
import numpy as np
import pytest
import torch
from jax_goldens import replayed
from torch_port import DATA, GOLDENS, JaxKey, jax_scene, jax_two_light_scene, mean_rel, tm_mad, to_port

from kajo_tpu.models import integrator as jax_integrator
from kajo_tpu.ops import geometry as jax_geometry
from kajo_tpu.scene.testscene import build_test_scene as jax_build_test_scene
from kajo_tpu_torch.models import integrator
from kajo_tpu_torch.models.integrator import RenderConfig
from kajo_tpu_torch.ops import geometry
from kajo_tpu_torch.ops.rng import CounterKey
from kajo_tpu_torch.scene import parser
from kajo_tpu_torch.scene.types import Camera, make_scene

W, H = 16, 12
LANE_TIGHT, LANE_LOOSE = 1e-5, 1e-3


def _scene(name, aspect):
    if name == "two-light":
        return jax_two_light_scene(aspect)
    if name == "testscene":
        return jax_build_test_scene(aspect)
    return jax_scene(name, aspect)


def _lanes(label, got, want):
    """Print how many lanes of [N, 4] radiance differ -> the shares within
    the tight and the loose bar."""
    rel = (np.abs(got - want) / np.maximum(1.0, np.abs(want))).max(-1)
    print(f"{label}: {int((rel > LANE_TIGHT).sum())} of {rel.size} lanes beyond {LANE_TIGHT} "
          f"({int((rel > LANE_LOOSE).sum())} beyond {LANE_LOOSE}), largest {rel.max():.3e}")
    assert np.isfinite(got).all()
    return float((rel <= LANE_TIGHT).mean()), float((rel <= LANE_LOOSE).mean())


CASES = {
    "caustics": ("caustics.json", {}),
    "scaled": ("scaled.json", {}),
    "testscene-parity": ("testscene", {}),
    "testscene-full-mis": ("testscene", dict(full_mis=True)),
    "testscene-no-direct": ("testscene", dict(direct_lighting=False)),
    "testscene-gl": ("testscene", dict(gl_semantics=True)),
    "two-light-one-light-nee": ("two-light", dict(one_light_nee=True)),
}


@replayed
def kajo_samples(js, o, d, key, cfg):
    samples = jax.jit(jax_integrator.render_samples, static_argnames="config")
    return {"out": samples(jax_geometry.prepare_scene(js), o, d, key, jax_integrator.RenderConfig(**cfg))}


@replayed
def kajo_pass_and_image(js, w, h, cfg):
    jcfg = jax_integrator.RenderConfig(**cfg)
    return {"pass": jax_integrator.render_pass(js, jax.random.PRNGKey(11), w, h, 4, jcfg),
            "image": jax_integrator.render_image(js, w, h, 1, jax.random.PRNGKey(12), passes=2, config=jcfg)}


@pytest.mark.parametrize("case", list(CASES))
def test_render_samples_matches_jax(case):
    name, cfg = CASES[case]
    js = _scene(name, W / H)
    jprep = jax_geometry.prepare_scene(js)
    r = np.random.default_rng(5)
    sx, sy = (r.random(W * H).astype(np.float32) for _ in range(2))
    o, d = (np.array(a) for a in jax_geometry.generate_rays(jprep.camera, sx, sy))
    key = 3
    want = kajo_samples(js, o, d, jax.random.PRNGKey(key), cfg)["out"]
    prep = geometry.prepare_scene(to_port(js))
    got = integrator.render_samples(prep, torch.from_numpy(o), torch.from_numpy(d), JaxKey(key), RenderConfig(**cfg))
    assert got.shape == (W * H, 4) and got.dtype == torch.float32
    tight, loose = _lanes(case, got.numpy(), want)
    assert loose >= 0.995 and tight >= 0.95, (tight, loose)


@pytest.mark.parametrize("case", ["caustics", "testscene-parity"])
def test_render_pass_and_image_match_jax(case):
    name, cfg = CASES[case]
    js = _scene(name, W / H)
    scene = to_port(js)
    pcfg = RenderConfig(**cfg)
    ref = kajo_pass_and_image(js, W, H, cfg)
    want = ref["pass"]
    got = integrator.render_pass(scene, JaxKey(11), W, H, 4, pcfg).numpy()
    assert got.shape == (H, W, 4)
    _lanes(f"{case} pass", got.reshape(-1, 4), want.reshape(-1, 4))
    assert tm_mad(got, want) <= 5e-4 and mean_rel(got, want) <= 0.01
    # render_image: pass p under fold_in(key, p)
    want = ref["image"]
    got = integrator.render_image(scene, W, H, 1, JaxKey(12), passes=2, config=pcfg).numpy()
    _lanes(f"{case} image", got.reshape(-1, 4), want.reshape(-1, 4))
    assert tm_mad(got, want) <= 5e-4 and mean_rel(got, want) <= 0.01


def test_kajo_spp_quirk_ratio_is_exact():
    # spp 32 takes 5x5 strata and divides by 32: exactly 25/32 of the
    # exact-spp normalisation for the same seed
    scene = to_port(jax_build_test_scene(W / H))
    a = integrator.render_pass(scene, 2, W, H, 32, RenderConfig(max_depth=3)).numpy()
    b = integrator.render_pass(scene, 2, W, H, 32, RenderConfig(max_depth=3, kajo_spp_quirk=False)).numpy()
    np.testing.assert_allclose(a, b * 25.0 / 32.0, rtol=1e-5)


def test_background_in_the_empty_scene_and_on_a_miss():
    bg = np.array([0.25, 0.5, 0.75, 1], np.float32)
    empty = make_scene(Camera.default(), bg, [], [], device="cpu")
    img = integrator.render_pass(empty, 0, 8, 8, 4).numpy()
    np.testing.assert_allclose(img[..., :3], np.broadcast_to(bg[:3], img[..., :3].shape), atol=1e-5)
    # rays that leave the scene at the first vertex see the background
    sphere = {"transform": np.eye(4, dtype=np.float32), "radius": 0.5, "material": {"diffuse": [0.5, 0.5, 0.5, 1]}}
    prep = geometry.prepare_scene(make_scene(Camera.default(), bg, [], [sphere], device="cpu"))
    o = torch.tensor([[5.0, 0.0, 0.0], [5.0, 0.0, 0.0]])
    d = torch.tensor([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    out = integrator.render_samples(prep, o, d, CounterKey(1), RenderConfig())
    np.testing.assert_array_equal(out.numpy(), np.broadcast_to(bg, (2, 4)))


def test_images_finite_non_negative_and_full_mis_adds_energy():
    scene = to_port(jax_build_test_scene(32 / 24))
    kajo = integrator.render_pass(scene, 7, 32, 24, 16).numpy()
    full = integrator.render_pass(scene, 7, 32, 24, 16, RenderConfig(full_mis=True)).numpy()
    for img in (kajo, full):
        assert np.isfinite(img).all() and (img[..., :3] >= 0).all()
    # the reference drops the BSDF-side MIS half; full_mis restores it
    rel = (full[..., :3].mean() - kajo[..., :3].mean()) / kajo[..., :3].mean()
    assert 0.0 < rel < 0.15, rel


def test_caustics_golden_with_the_counter_key():
    scene = parser.load(os.path.join(DATA, "caustics.json"), 32 / 24, "cpu")
    img = integrator.render_image(scene, 32, 24, 16, 17, passes=10).numpy()
    golden = np.fromfile(os.path.join(GOLDENS, "caustics_32x24.raw"), np.float32).reshape(24, 32, 4)
    mad, rel = tm_mad(img, golden), mean_rel(img, golden)
    print(f"parity engine vs the C++ golden: tm_mad {mad:.4f}, mean_rel {rel:.4f}")
    assert np.isfinite(img).all() and mad < 0.1 and rel < 0.25


def test_counter_key_is_deterministic_and_its_streams_differ():
    a, b = CounterKey(5), CounterKey(5)
    assert torch.equal(a.uniform((3, 7), "cpu"), b.uniform((3, 7), "cpu"))
    assert torch.equal(a.fold_in(2).uniform((64,), "cpu"), b.fold_in(2).uniform((64,), "cpu"))
    u = a.uniform((4096,), "cpu")
    assert u.dtype == torch.float32 and 0.0 <= float(u.min()) and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.02
    streams = [a, CounterKey(6), a.fold_in(0), a.fold_in(1), a.fold_in(0).fold_in(1), *a.split(3),
               a.split(2)[0].fold_in(0)]
    draws = [k.uniform((256,), "cpu") for k in streams]
    for i in range(len(draws)):
        for j in range(i):
            assert not torch.equal(draws[i], draws[j]), (i, j)
