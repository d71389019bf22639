"""The CUDA megakernel against its plain PyTorch version on the card.

Needs a CUDA device, nvcc and no jax, so on a GPU machine run it without the
JAX test configuration:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Elsewhere every test skips."""

import os

import pytest
import torch

from kajo_tpu_torch.models.integrator import RenderConfig
from kajo_tpu_torch.ops import megakernel
from kajo_tpu_torch.scene import parser
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
