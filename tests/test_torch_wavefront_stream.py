"""The port's wavefront on a streamed scene against kajo_tpu's, same u32
seed: ``random_spheres_scene(400)`` with ``STREAM_THRESHOLD`` lowered to 64
in both packages, so both take the big-scene path (K5/K6 plain versions in
the port, the V4 kernels in Pallas interpret mode in kajo_tpu), the lane
multiplier and the tiled lane order. 32 x 24, 4 spp, depth 2; bars as in
test_torch_wavefront.py: tone-mapped MAD <= 5e-4, mean relative gap <= 1%.

The control: the same scene and seed through the dense trace in both
packages (threshold 1000). Last-bit differences (the camera's 4x4 inverse,
XLA's fused multiply-adds) send a few percent of this scene's paths
elsewhere in both modes (``tests/_wavefront_divergence.py`` finds where;
``test_torch_wavefront_replay.py`` holds each iteration), so the streamed
pass must be no further from kajo_tpu than the dense one is."""

import jax
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu
from jax_goldens import replayed
from torch_port import mean_rel, tm_mad, to_port

from kajo_tpu.models.integrator import RenderConfig as JaxRenderConfig
from kajo_tpu.models.wavefront import render_pass_fast as jax_render_pass_fast
from kajo_tpu.ops import geometry as jgeo
from kajo_tpu.ops.rng import seed_from_key
from kajo_tpu.scene.procedural import random_spheres_scene as jax_random_spheres_scene
from kajo_tpu_torch.models import wavefront
from kajo_tpu_torch.models.integrator import RenderConfig
from kajo_tpu_torch.ops import geometry, stream_trace

W, H, SPP = 32, 24, 4


@replayed
def kajo_fast_pass(js, key, w, h, spp, config, threshold):
    """kajo_tpu's pass in interpret mode with STREAM_THRESHOLD ``threshold``
    and FORCE_STREAM."""
    # the JAX pass is jitted with the stream flags baked in: clear its cache
    # on both sides of the flag change
    flags = jgeo.STREAM_THRESHOLD, jgeo.FORCE_STREAM
    jgeo.STREAM_THRESHOLD, jgeo.FORCE_STREAM = threshold, True
    jax_render_pass_fast.clear_cache()
    try:
        with pltpu.force_tpu_interpret_mode():
            return {"img": jax_render_pass_fast(js, key, w, h, spp, JaxRenderConfig(max_depth=2, **config))}
    finally:
        jgeo.STREAM_THRESHOLD, jgeo.FORCE_STREAM = flags
        jax_render_pass_fast.clear_cache()


def _both(js, key, config, threshold, monkeypatch):
    """The pass in both packages with STREAM_THRESHOLD ``threshold`` ->
    (port image, kajo_tpu image, the port's prepared scene)."""
    want = kajo_fast_pass(js, key, W, H, SPP, config, threshold)["img"]
    monkeypatch.setattr(geometry, "STREAM_THRESHOLD", threshold)
    ts = to_port(js)
    got = wavefront.render_pass_fast(ts, int(seed_from_key(key)), W, H, SPP, RenderConfig(max_depth=2, **config)).numpy()
    return got, want, geometry.prepare_scene(ts)


def _far(got, want):
    return int((np.abs(got[..., :3] - want[..., :3]).max(-1) > 1e-3).sum())


@pytest.mark.parametrize(
    "config", [{}, {"one_light_nee": True}, {"gl_semantics": True, "regen_threshold": 0.01}], ids=["nee", "one-light", "gl"]
)
def test_streamed_pass_matches_jax(config, monkeypatch):
    js = jax_random_spheres_scene(400, seed=21, extent=15.0, n_lights=3)
    key = jax.random.PRNGKey(7)
    before = (stream_trace.nearest_launches, stream_trace.occluded_launches)
    got, want, prep = _both(js, key, config, 64, monkeypatch)
    assert prep.stream_packed is not None
    assert (stream_trace.nearest_launches, stream_trace.occluded_launches) == before  # plain versions on the CPU
    assert np.isfinite(got).all() and got[..., :3].mean() > 0
    mad, rel = tm_mad(got, want), mean_rel(got, want)

    # the control: the dense trace in both packages
    got_d, want_d, prep_d = _both(js, key, config, 1000, monkeypatch)
    assert prep_d.stream_packed is None
    mad_d, rel_d = tm_mad(got_d, want_d), mean_rel(got_d, want_d)
    print(f"{config}: streamed tone-mapped MAD {mad:.3e}, mean relative gap {rel:.3e}, {_far(got, want)} pixels "
          f"off by > 1e-3; dense control MAD {mad_d:.3e}, gap {rel_d:.3e}, {_far(got_d, want_d)} pixels")  # pytest -rP
    assert mad <= 5e-4, mad
    assert rel <= 0.01, rel
    assert rel_d <= 0.01, rel_d
    assert mad <= mad_d, (mad, mad_d)
