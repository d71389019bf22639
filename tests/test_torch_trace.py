"""The port's scene generator, camera rays, dense trace and NEE visibility
against kajo_tpu's, and the port's streamed trace (K5/K6 plain versions)
against its own dense trace.

Scenes: ``build_test_scene`` (planes, rigid spheres, refraction) and
``random_spheres_scene(300)`` rigid and with ``scale_jitter`` (the general
record). Rays: a screen grid of primary rays and random scattered rays made
with numpy. Dense dot products differ between the packages in rounding
order only (JAX: a matrix product with fused multiply-adds, the port:
elementwise sums), and the stable quadratic amplifies those last bits near
tangency, so hit distances are held to rtol 1e-4, the bar kajo_tpu's own
chunked-versus-dense test sets for the same cause; winners must agree on
every ray."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port import to_port

from kajo_tpu.models.wavefront import tiled_pixel_order as jax_tiled_pixel_order
from kajo_tpu.ops import geometry as jgeo
from kajo_tpu.ops import lights as jlights
from kajo_tpu.scene.procedural import random_spheres_scene as jax_random_spheres_scene
from kajo_tpu.scene.testscene import build_test_scene as jax_build_test_scene
from kajo_tpu_torch.models.wavefront import tiled_pixel_order
from kajo_tpu_torch.ops import geometry, lights
from kajo_tpu_torch.scene.procedural import random_spheres_scene

T = torch.tensor


def _jax_scene(name):
    if name == "testscene":
        return jax_build_test_scene(4 / 3)
    return jax_random_spheres_scene(300, seed=2, extent=15.0, n_lights=2, scale_jitter=0.5 if name == "jitter" else 0.0)


def _rays(jprep, seed=1):
    """24 x 16 primary rays (from JAX) and as many scattered rays (numpy)."""
    xs, ys = np.meshgrid(np.linspace(0.02, 0.98, 24), np.linspace(0.02, 0.98, 16))
    sx, sy = xs.ravel().astype(np.float32), ys.ravel().astype(np.float32)
    o, d = jgeo.generate_rays(jprep.camera, jnp.asarray(sx), jnp.asarray(sy))
    rng = np.random.default_rng(seed)
    m = sx.shape[0]
    o_sc = rng.uniform(-8, 8, (m, 3)).astype(np.float32)
    o_sc[:, 1] = rng.uniform(-3, 0.9, m)
    d_sc = rng.normal(size=(m, 3)).astype(np.float32)
    d_sc /= np.linalg.norm(d_sc, axis=1, keepdims=True)
    return (sx, sy), np.concatenate([np.asarray(o), o_sc]), np.concatenate([np.asarray(d), d_sc])


@pytest.mark.parametrize("jitter", [0.0, 0.6])
def test_random_spheres_scene_equals_jax(jitter):
    js = jax_random_spheres_scene(1200, seed=5, extent=30.0, scale_jitter=jitter)
    ts = random_spheres_scene(1200, seed=5, extent=30.0, scale_jitter=jitter, device="cpu")
    assert ts.rigid_spheres == js.rigid_spheres == (jitter == 0.0)
    assert ts.light_indices == js.light_indices
    want = dataclasses.asdict(jax.tree.map(np.asarray, js))
    got = dataclasses.asdict(ts)

    def walk(a, b, path):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], f"{path}.{k}")
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b.numpy(), a, err_msg=path)

    walk(want, got, "scene")


def test_tiled_pixel_order_equals_jax():
    for w, h in [(128, 96), (100, 70), (32, 24)]:
        np.testing.assert_array_equal(tiled_pixel_order(w, h), jax_tiled_pixel_order(w, h))


@pytest.mark.parametrize("name", ["testscene", "rigid", "jitter"])
def test_generate_rays_and_dense_trace(name):
    js = _jax_scene(name)
    jprep, prep = jgeo.prepare_scene(js), geometry.prepare_scene(to_port(js))
    assert prep.stream_packed is None
    (sx, sy), o, d = _rays(jprep)
    # the same basis in both (the float32 inverses of proj @ view differ
    # between LAPACK builds by more than the ray arithmetic does)
    c = jprep.camera
    basis = geometry.CameraBasis(*(T(np.asarray(x)) for x in (c.origin, c.p1, c.du, c.dv)))
    o_t, d_t = geometry.generate_rays(basis, T(sx), T(sy))
    np.testing.assert_allclose(d_t.numpy(), d[: sx.shape[0]], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(o_t.numpy(), o[: sx.shape[0]], rtol=1e-6, atol=1e-6)

    want = jgeo.trace(jprep, jnp.asarray(o), jnp.asarray(d))
    got = geometry.trace(prep, T(o), T(d))
    np.testing.assert_array_equal(got.obj.numpy(), np.asarray(want.obj))
    hit = np.asarray(want.obj) >= 0
    assert hit.sum() > 100
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit], rtol=1e-4)
    assert np.isinf(got.t.numpy()[~hit]).all()
    np.testing.assert_allclose(got.position.numpy(), np.asarray(want.position), rtol=1e-4, atol=1e-4)
    # grazing hits on small spheres amplify t's last bits into the normal:
    # angular agreement on 99.5% of the hits, as kajo_tpu's own dense tests
    for field in ("normal", "tangent", "binormal"):
        cos = np.sum(getattr(got, field).numpy() * np.asarray(getattr(want, field)), -1)[hit]
        assert np.percentile(cos, 0.5) > 0.9999, field


def _shadow_rays(jprep, o, d, seed=3):
    """From each primary/scattered hit, one ray toward a sampled point of a
    random light -> (o, d, center, radius, lobj) as numpy."""
    hit = jgeo.trace(jprep, jnp.asarray(o), jnp.asarray(d))
    rng = np.random.default_rng(seed)
    n = o.shape[0]
    li = rng.integers(0, jprep.light_obj.shape[0], n)
    center, radius = np.asarray(jprep.light_center)[li], np.asarray(jprep.light_radius)[li]
    u = rng.uniform(0, 1, (3, n)).astype(np.float32)
    dl, _ = jlights.sample(*(jnp.asarray(x) for x in u), jnp.asarray(center), jnp.asarray(radius), hit.position)
    so = np.asarray(hit.position + dl * 1e-3)
    return so, np.asarray(dl), center, radius, np.asarray(jprep.light_obj)[li]


@pytest.mark.parametrize("name", ["testscene", "rigid"])
def test_dense_light_visible(name):
    js = _jax_scene(name)
    jprep, prep = jgeo.prepare_scene(js), geometry.prepare_scene(to_port(js))
    _, o, d = _rays(jprep)
    so, sd, center, radius, lobj = _shadow_rays(jprep, o, d)
    want = np.asarray(jgeo.light_visible(jprep, *(jnp.asarray(x) for x in (so, sd, center, radius, lobj))))
    got = geometry.light_visible(prep, T(so), T(sd), T(center), T(radius), T(lobj).long()).numpy()
    assert 0.05 < want.mean() < 0.98
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["rigid", "jitter"])
def test_streamed_trace_and_visibility_match_dense(name, monkeypatch):
    """Above STREAM_THRESHOLD the trace goes through K5 and (rigid)
    visibility through K6 with the light's packed row excluded; lowered to
    64, the same scene must give the dense answers on every ray."""
    scene = to_port(_jax_scene(name))
    jprep = jgeo.prepare_scene(_jax_scene(name))
    dense = geometry.prepare_scene(scene)
    monkeypatch.setattr(geometry, "STREAM_THRESHOLD", 64)
    streamed = geometry.prepare_scene(scene)
    assert dense.stream_packed is None and streamed.stream_packed is not None
    _, o, d = _rays(jprep)
    a, b = geometry.trace(dense, T(o), T(d)), geometry.trace(streamed, T(o), T(d))
    assert torch.equal(a.obj, b.obj)
    hit = a.obj >= 0
    torch.testing.assert_close(b.t[hit], a.t[hit], rtol=1e-5, atol=0)
    so, sd, center, radius, lobj = (torch.tensor(x) for x in _shadow_rays(jprep, o, d))
    args = (so, sd, center, radius, lobj.long())
    want = geometry.light_visible(dense, *args)
    assert torch.equal(geometry.light_visible(streamed, *args), want)
    # a lane that is not needed is "occluded" at no cost; the others keep their answer
    needed = torch.arange(so.shape[0]) % 3 != 0
    got = geometry.light_visible(streamed, *args, needed=needed)
    assert torch.equal(got[needed], want[needed])
