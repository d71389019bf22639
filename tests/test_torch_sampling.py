"""The port's samplers, BSDFs and light functions against kajo_tpu's on the
same numpy-seeded inputs. Both compute in float32 with the same operation
order; transcendentals (pow, sin, cos) come from different libraries and
may differ in the last bits, hence rtol 1e-6 (about 8 ulps). A Phong value
cosⁿ has condition number n in cos: an ulp of difference in cos (pow(u,
1/(n+1)) from two libraries) becomes n ulps, so values that go through a
Phong power are held to rtol 1e-6 x (n + 1)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kajo_tpu.ops import bsdf as jbsdf
from kajo_tpu.ops import lights as jlights
from kajo_tpu.ops import sampling as jsampling
from kajo_tpu_torch.ops import bsdf, lights, sampling

N = 4096
RTOL, ATOL = 1e-6, 1e-6


def _inputs(seed):
    rng = np.random.default_rng(seed)
    u = rng.uniform(0, 1, (4, N)).astype(np.float32)
    u[:, :4] = [0.0, 1e-7, 0.5, 0.9999999]  # edges of [0, 1)

    def unit(n):
        v = rng.normal(size=(n, 3)).astype(np.float32)
        return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)

    normal, view = unit(N), unit(N)
    view[: N // 2] = -np.abs(view[: N // 2])
    exp = rng.choice(np.array([0.0, 1.0, 20.0, 150.0], np.float32), N)
    return u, normal, view, exp


def _same(got, want, exponent=None):
    """Elementwise |got - want| <= ATOL + rtol |want|; rtol is RTOL, times
    (n + 1) per element where the value goes through cos^n."""
    got = [g.numpy() for g in (got if isinstance(got, tuple) else (got,))]
    want = [np.asarray(w) for w in (want if isinstance(want, tuple) else (want,))]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.dtype == bool:
            np.testing.assert_array_equal(g, w)
            continue
        rtol = RTOL if exponent is None else RTOL * (exponent + 1.0).reshape(-1, *([1] * (w.ndim - 1)))
        bad = ~(np.abs(g - w) <= ATOL + rtol * np.abs(w))
        assert not bad.any(), f"{bad.sum()} of {bad.size} differ, first got {g[bad][:4]} want {w[bad][:4]}"


T, J = torch.from_numpy, jnp.asarray


@pytest.mark.parametrize("seed", [0, 1])
def test_scalar_helpers(seed):
    u, _, _, exp = _inputs(seed)
    x = np.concatenate([u[0] * 4 - 1, np.zeros(8, np.float32)])
    e = np.concatenate([exp, np.zeros(8, np.float32)])[: x.shape[0]]
    _same(sampling.safe_sqrt(T(x)), jsampling.safe_sqrt(J(x)))
    # exponent 0 gives 1 even at x = 0 (powf semantics), not NaN
    base = np.concatenate([u[1], np.zeros(8, np.float32)])
    got = sampling.safe_pow(T(base), T(e))
    assert torch.isfinite(got).all() and (got[-8:] == 1).all()
    _same(got, jsampling.safe_pow(J(base), J(e)))
    v = np.concatenate([u[:3].T * 2 - 1, np.zeros((1, 3), np.float32)])
    _same(sampling.safe_normalize(T(v)), jsampling.safe_normalize(J(v)))
    coin = u[1] * 1.2 - 0.1
    _same(sampling.flip_coin(T(u[0]), T(coin)), jsampling.flip_coin(J(u[0]), J(coin)))


@pytest.mark.parametrize("seed", [2, 3])
def test_hemisphere_lobe_and_frame(seed):
    u, normal, view, exp = _inputs(seed)
    _same(sampling.cosine_hemisphere(T(u[0]), T(u[1])), jsampling.cosine_hemisphere(J(u[0]), J(u[1])))
    _same(sampling.phong_lobe(T(u[0]), T(u[1]), T(exp)), jsampling.phong_lobe(J(u[0]), J(u[1]), J(exp)), exp)
    local = np.stack([u[0], u[1], u[2]], 1)
    _same(
        sampling.local_to_world(T(local), T(view), T(normal), T(normal)),
        jsampling.local_to_world(J(local), J(view), J(normal), J(normal)),
    )


@pytest.mark.parametrize("seed", [4, 5])
def test_bsdfs(seed):
    u, normal, view, exp = _inputs(seed)
    rng = np.random.default_rng(seed + 100)
    color = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    ior = rng.uniform(1.0, 2.0, N).astype(np.float32)
    tangent = np.cross(normal, [0.3, 0.5, 0.8]).astype(np.float32)
    tangent /= np.linalg.norm(tangent, axis=1, keepdims=True)
    binormal = np.cross(normal, tangent).astype(np.float32)
    dirs, _ = jsampling.cosine_hemisphere(J(u[2]), J(u[3]))
    d = np.asarray(dirs) * np.where(u[0] < 0.3, -1, 1)[:, None].astype(np.float32)

    _same(
        bsdf.lambert_sample(T(u[0]), T(u[1]), T(tangent), T(binormal), T(normal)),
        jbsdf.lambert_sample(J(u[0]), J(u[1]), J(tangent), J(binormal), J(normal)),
    )
    _same(bsdf.lambert_eval_cos(T(color), T(normal), T(d)), jbsdf.lambert_eval_cos(J(color), J(normal), J(d)))
    _same(bsdf.lambert_pdf(T(normal), T(d)), jbsdf.lambert_pdf(J(normal), J(d)))
    _same(
        bsdf.phong_sample(T(u[0]), T(u[1]), T(view), T(normal), T(exp)),
        jbsdf.phong_sample(J(u[0]), J(u[1]), J(view), J(normal), J(exp)),
        exp,
    )
    _same(
        bsdf.phong_eval_cos(T(color), T(view), T(normal), T(d), T(exp)),
        jbsdf.phong_eval_cos(J(color), J(view), J(normal), J(d), J(exp)),
        exp,
    )
    _same(bsdf.phong_pdf(T(view), T(normal), T(d), T(exp)), jbsdf.phong_pdf(J(view), J(normal), J(d), J(exp)), exp)
    _same(bsdf.reflector_sample(T(view), T(normal)), jbsdf.reflector_sample(J(view), J(normal)))
    _same(
        bsdf.reflector_eval_cos(T(color), T(normal), T(d)), jbsdf.reflector_eval_cos(J(color), J(normal), J(d))
    )
    _same(
        bsdf.transmission_sample(T(view), T(normal), T(ior)), jbsdf.transmission_sample(J(view), J(normal), J(ior))
    )
    _same(
        bsdf.transmission_eval_abscos(T(color), T(normal), T(d)),
        jbsdf.transmission_eval_abscos(J(color), J(normal), J(d)),
    )


@pytest.mark.parametrize("seed", [6, 7])
def test_lights(seed):
    u, _, _, _ = _inputs(seed)
    rng = np.random.default_rng(seed + 200)
    center = rng.uniform(-5, 5, (N, 3)).astype(np.float32)
    radius = rng.uniform(0.05, 2.0, N).astype(np.float32)
    pos = (center + rng.normal(size=(N, 3)) * rng.choice([0.1, 3.0, 500.0], (N, 1))).astype(np.float32)
    # inside the sphere (4π), at its center (the clamped distance), far and grazing
    pos[0], pos[1] = center[0], center[1] + 0.5 * radius[1]
    args_t = (T(center), T(radius), T(pos))
    args_j = (J(center), J(radius), J(pos))
    _same(lights.solid_angle(*args_t), jlights.solid_angle(*args_j))
    _same(lights.pdf(*args_t), jlights.pdf(*args_j))
    _same(
        lights.sample(T(u[0]), T(u[1]), T(u[2]), *args_t),
        jlights.sample(J(u[0]), J(u[1]), J(u[2]), *args_j),
    )
