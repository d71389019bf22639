"""The port's wavefront engine against kajo_tpu's ``render_pass_fast`` on
dense scenes, same u32 seed, 32 x 24, 4 spp, depth 2. The two packages
trace the same PCG4D paths; last bits of transcendentals and of the dense
dot products differ, which moves a rare path across a branch. Bars (those
of the megakernel port tests): tone-mapped MAD <= 5e-4 and mean relative
gap <= 1%."""

import jax
import numpy as np
import pytest
import torch
from torch_port import jax_scene, jax_two_light_scene, mean_rel, tm_mad, to_port

from kajo_tpu.models.integrator import RenderConfig as JaxRenderConfig
from kajo_tpu.models.wavefront import render_pass_fast as jax_render_pass_fast
from kajo_tpu.models.wavefront import render_pass_fast_stats as jax_render_pass_fast_stats
from kajo_tpu.ops.rng import seed_from_key
from kajo_tpu_torch.models import wavefront
from kajo_tpu_torch.models.integrator import RenderConfig
from kajo_tpu_torch.ops.rng import pass_seed

W, H, SPP = 32, 24, 4


def _jax(scene, key_int, **config):
    key = jax.random.PRNGKey(key_int)
    img = jax_render_pass_fast(scene, key, W, H, SPP, JaxRenderConfig(max_depth=2, **config))
    return np.asarray(img), int(seed_from_key(key))


@pytest.mark.parametrize(
    "name,config",
    [
        ("caustics.json", {}),
        ("scaled.json", {}),
        ("two-light", {"one_light_nee": True}),
        ("two-light", {"gl_semantics": True, "regen_threshold": 0.01}),
        ("two-light", {"full_mis": True}),
    ],
    ids=["caustics", "scaled", "one-light", "gl", "full-mis"],
)
def test_dense_pass_matches_jax(name, config):
    js = jax_two_light_scene(W / H) if name == "two-light" else jax_scene(name, W / H)
    want, seed = _jax(js, 5, **config)
    got = wavefront.render_pass_fast(to_port(js), seed, W, H, SPP, RenderConfig(max_depth=2, **config)).numpy()
    assert got.shape == (H, W, 4) and np.isfinite(got).all() and (got[..., 3] == 1).all()
    assert got[..., :3].mean() > 0
    mad, rel = tm_mad(got, want), mean_rel(got, want)
    print(f"dense {name} {config}: tone-mapped MAD {mad:.3e}, mean relative gap {rel:.3e}")  # shown by pytest -rP
    assert mad <= 5e-4, mad
    assert rel <= 0.01, rel


def test_passes_sum_the_single_passes():
    ts = to_port(jax_two_light_scene(24 / 16))
    cfg = RenderConfig(max_depth=2)
    total = wavefront.render_passes_fast(ts, 5, 7, 24, 16, 4, 3, cfg)
    single = sum(wavefront.render_pass_fast(ts, pass_seed(5, 7 + i), 24, 16, 4, cfg) for i in range(3))
    assert torch.equal(total, single)


def test_stats_match_jax():
    """Dense scenes: the same pass, the same iteration count, and rays within
    f32 accumulation of JAX's counter."""
    js = jax_scene("caustics.json", W / H)
    key = jax.random.PRNGKey(2)
    cfg = dict(max_depth=3)
    want, iters_j, rays_j = jax_render_pass_fast_stats(js, key, W, H, SPP, JaxRenderConfig(**cfg))
    img, iters, rays = wavefront.render_pass_fast_stats(to_port(js), int(seed_from_key(key)), W, H, SPP, RenderConfig(**cfg))
    assert torch.equal(img, wavefront.render_pass_fast(to_port(js), int(seed_from_key(key)), W, H, SPP, RenderConfig(**cfg)))
    assert tm_mad(img.numpy(), np.asarray(want)) <= 5e-4
    assert abs(iters - int(iters_j)) <= 1
    assert rays > W * H * 4 and abs(rays / float(rays_j) - 1) < 0.01
