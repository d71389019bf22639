"""The CUDA kernels against their plain PyTorch versions on the card: the
megakernel (K1) and the streaming trace (K5 nearest hit, K6 occlusion).

Needs a CUDA device, nvcc and no jax, so on a GPU machine run it without the
JAX test configuration:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Elsewhere every test skips."""

import os

import numpy as np
import pytest
import torch

from kajo_tpu_torch.models import wavefront
from kajo_tpu_torch.models.integrator import RenderConfig
from kajo_tpu_torch.ops import geometry, megakernel, stream_trace
from kajo_tpu_torch.scene import parser
from kajo_tpu_torch.scene.procedural import random_spheres_scene
from kajo_tpu_torch.scene.testscene import build_two_light_scene

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tm(x):
    return x[..., :3].clamp(0, 1) ** (1 / 2.2)


@pytest.mark.parametrize(
    "name,config",
    [
        ("caustics.json", RenderConfig()),
        ("scaled.json", RenderConfig()),
        ("two-light", RenderConfig(one_light_nee=True)),
        ("two-light", RenderConfig(full_mis=True, regen_threshold=0.01)),
    ],
    ids=["caustics", "scaled", "one-light", "full-mis-regen"],
)
def test_kernel_matches_plain(device, name, config):
    if name == "two-light":
        scene = build_two_light_scene(64 / 48, device)
    else:
        scene = parser.load(os.path.join(DATA, name), 64 / 48, device)
    before = megakernel.kernel_launches
    got = megakernel.render_pass_megakernel(scene, 1234, 64, 48, 4, config)
    want = megakernel.render_pass_megakernel_plain(scene, 1234, 64, 48, 4, config)
    torch.cuda.synchronize()
    assert megakernel.kernel_launches == before + 1
    assert torch.isfinite(got).all()
    # same stream and float expressions: only ulps of transcendentals differ
    assert (_tm(got) - _tm(want)).abs().mean().item() <= 5e-4
    assert abs(got[..., :3].mean() / want[..., :3].mean() - 1).item() <= 0.01


def test_scene_on_cuda_never_runs_plain(device, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA scene reached the plain version")

    monkeypatch.setattr(megakernel, "trace_lanes_plain", refuse)
    scene = parser.load(os.path.join(DATA, "caustics.json"), 1.0, device)
    img = megakernel.render_passes_megakernel(scene, 3, 0, 16, 16, 4, 2)
    torch.cuda.synchronize()
    assert img.device.type == "cuda" and torch.isfinite(img).all()


def _stream_rays(prep, n_side=64, seed=0):
    """n_side² primary rays and as many scattered ones, made with numpy."""
    xs, ys = np.meshgrid(np.linspace(0.01, 0.99, n_side), np.linspace(0.01, 0.99, n_side))
    dev = prep.sphere_center.device
    o_p, d_p = geometry.generate_rays(
        prep.camera, torch.tensor(xs.ravel(), dtype=torch.float32, device=dev),
        torch.tensor(ys.ravel(), dtype=torch.float32, device=dev),
    )
    rng = np.random.default_rng(seed)
    m = n_side * n_side
    o_s = rng.uniform(-30, 30, (m, 3)).astype(np.float32)
    o_s[:, 1] = rng.uniform(-2, 0.99, m)
    d_s = rng.normal(size=(m, 3)).astype(np.float32)
    d_s /= np.linalg.norm(d_s, axis=1, keepdims=True)
    o = torch.cat([o_p, torch.tensor(o_s, device=dev)]).contiguous()
    d = torch.cat([d_p, torch.tensor(d_s, device=dev)]).contiguous()
    bound = torch.tensor(rng.uniform(1, 80, 2 * m).astype(np.float32), device=dev)
    bound[::3] = stream_trace.BIG
    return o, d, bound


@pytest.mark.parametrize("jitter", [0.0, 0.5], ids=["rigid", "general"])
def test_stream_kernels_match_plain(device, jitter):
    """Same winners on every ray and t equal to the bit (K5); the same
    occlusion on every ray, the light's row excluded on half of them (K6)."""
    prep = geometry.prepare_scene(random_spheres_scene(20000, seed=3, extent=30.0, scale_jitter=jitter, device=device))
    o, d, bound = _stream_rays(prep)
    args = (prep.rigid, o, d, bound, prep.stream_packed, prep.stream_boxes)
    before = (stream_trace.nearest_launches, stream_trace.occluded_launches)
    t_k, i_k = stream_trace.launch_nearest(*args)
    t_p, i_p = stream_trace.nearest_sphere_plain(*args)
    torch.cuda.synchronize()
    assert int((i_p >= 0).sum()) > 1000
    assert torch.equal(i_k, i_p)
    assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
    excl = torch.where(torch.arange(o.shape[0], device=device) % 2 == 0, i_p, -1).to(torch.int32)
    cut = torch.where(i_p >= 0, t_p * 1.5, bound)
    args = (prep.rigid, o, d, cut, excl, prep.stream_packed, prep.stream_boxes)
    occ_k = stream_trace.launch_occluded(*args)
    occ_p = stream_trace.occluded_sphere_plain(*args)
    torch.cuda.synchronize()
    assert 0 < int((occ_p == 0).sum()) < o.shape[0]
    assert torch.equal(occ_k.view(torch.int32), occ_p.view(torch.int32))
    assert (stream_trace.nearest_launches, stream_trace.occluded_launches) == (before[0] + 1, before[1] + 1)


def test_streamed_pass_launches_the_stream_kernels(device, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA trace reached a plain version")

    monkeypatch.setattr(stream_trace, "nearest_sphere_plain", refuse)
    monkeypatch.setattr(stream_trace, "occluded_sphere_plain", refuse)
    scene = random_spheres_scene(3000, seed=2, extent=20.0, n_lights=3, device=device)
    before = (stream_trace.nearest_launches, stream_trace.occluded_launches)
    img = wavefront.render_pass_fast(scene, 9, 64, 48, 4, RenderConfig(max_depth=2, one_light_nee=True))
    torch.cuda.synchronize()
    assert torch.isfinite(img).all() and img[..., :3].mean() > 0
    assert stream_trace.nearest_launches > before[0] and stream_trace.occluded_launches > before[1]
