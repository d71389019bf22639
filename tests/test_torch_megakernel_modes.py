"""Port megakernel estimator modes against the JAX megakernel in interpret
mode, on a two-light scene built with make_scene, same u32 seed; bars as in
test_torch_megakernel.py. Each mode must also change the port's image, so a
knob that is silently ignored fails."""

import numpy as np
import pytest
from torch_port import jax_pass, jax_two_light_scene, mean_rel, tm_mad, to_port

from kajo_tpu_torch.models.integrator import RenderConfig
from kajo_tpu_torch.ops import megakernel

W, H, SPP = 24, 16, 4


@pytest.mark.parametrize(
    "mode", [{"full_mis": True}, {"one_light_nee": True}, {"regen_threshold": 0.01}], ids=str
)
def test_mode_matches_jax_megakernel(mode):
    js = jax_two_light_scene(W / H)
    assert js.num_lights == 2
    want, seed = jax_pass(js, 9, W, H, SPP, **mode)
    ts = to_port(js)
    got = megakernel.render_pass_megakernel(ts, seed, W, H, SPP, RenderConfig(**mode)).numpy()
    assert np.isfinite(got).all()
    assert tm_mad(got, want) <= 5e-4
    assert mean_rel(got, want) <= 0.01
    default = megakernel.render_pass_megakernel(ts, seed, W, H, SPP).numpy()
    assert np.abs(got - default).max() > 1e-6
