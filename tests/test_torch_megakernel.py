"""Port megakernel pass (plain PyTorch version, as the CPU runs it) against the
JAX megakernel in interpret mode, same u32 seed. Only ulps of transcendentals
differ between the two, so almost every path is identical. Bars: per-pixel
tone-mapped MAD <= 5e-4 (the mega-vs-wavefront bar of test_megakernel.py)
and mean relative gap <= 1%."""

import numpy as np
import pytest
import torch
from torch_port import jax_pass, jax_scene, mean_rel, tm_mad, to_port

from kajo_tpu_torch.models.integrator import RenderConfig
from kajo_tpu_torch.ops import megakernel


@pytest.mark.parametrize("name", ["caustics.json", "scaled.json"])
def test_plain_matches_jax_megakernel(name):
    js = jax_scene(name, 1.0)
    want, seed = jax_pass(js, 3, 16, 16, 4)
    ts = to_port(js)
    # caustics: rigid record + delta BSDFs and refraction; scaled: general record
    assert ts.rigid_spheres == (name == "caustics.json")
    got = megakernel.render_pass_megakernel(ts, seed, 16, 16, 4).numpy()
    assert got.shape == (16, 16, 4) and np.isfinite(got).all()
    assert (got[..., 3] == 1).all()
    assert tm_mad(got, want) <= 5e-4
    assert mean_rel(got, want) <= 0.01


def test_gl_semantics_raises():
    ts = to_port(jax_scene("caustics.json", 1.0))
    with pytest.raises(ValueError, match="gl_semantics"):
        megakernel.render_pass_megakernel(ts, 1, 8, 8, 4, RenderConfig(gl_semantics=True))


def test_lane0_renders_the_same_lanes():
    """Lanes are independent: a pass started at lane0 equals the whole pass
    on those pixels, bit for bit, and leaves the pixels before it at 0."""
    ts = to_port(jax_scene("scaled.json", 1.5))
    full = megakernel.render_pass_megakernel(ts, 11, 12, 8, 4).reshape(-1, 4)
    part = megakernel.render_pass_megakernel(ts, 11, 12, 8, 4, lane0=37).reshape(-1, 4)
    assert torch.equal(part[37:], full[37:])
    assert (part[:37, :3] == 0).all()


def test_passes_sum_the_pass_seeds():
    from kajo_tpu_torch.ops.rng import pass_seed

    ts = to_port(jax_scene("caustics.json", 1.5))
    total = megakernel.render_passes_megakernel(ts, 5, 2, 12, 8, 4, 2)
    one = [megakernel.render_pass_megakernel(ts, pass_seed(5, p), 12, 8, 4) for p in (2, 3)]
    assert torch.equal(total, one[0] + one[1])
    assert megakernel.kernel_launches == 0  # the CPU runs the plain version
