"""The frozen reference agrees with itself and with the port's plain K1."""

import pytest
import torch

from benchmark import harness
from benchmark.reference import rng, scene, walk

W, H, SPP = 12, 8, 4


@pytest.mark.parametrize("name", ["caustics", "scaled"])
def test_batch_equals_its_passes_one_by_one(name):
    rs = scene.load_packed(harness.HERE / "scenes" / f"{name}.json", W / H, "cpu")
    est = walk.Estimator()
    both = walk.batch_image(rs, 99, 3, 2, W, H, SPP, est)
    one = walk.batch_image(rs, 99, 3, 1, W, H, SPP, est) + walk.batch_image(rs, 99, 4, 1, W, H, SPP, est)
    assert torch.equal(both, one)
    assert torch.equal(both, walk.batch_image(rs, 99, 3, 2, W, H, SPP, est))
    assert bool((both[..., 3] == 2.0).all()) and float(both[..., :3].mean()) > 0


def test_scene_records():
    caustics = scene.load_packed(harness.HERE / "scenes" / "caustics.json", W / H, "cpu")
    scaled = scene.load_packed(harness.HERE / "scenes" / "scaled.json", W / H, "cpu")
    assert (caustics.n_planes, caustics.n_spheres, caustics.n_lights, caustics.rigid) == (6, 4, 1, True)
    assert (scaled.n_planes, scaled.n_spheres, scaled.n_lights, scaled.rigid) == (1, 4, 1, False)
    # planes, spheres, materials, lights, background, camera
    assert caustics.packed.numel() == 6 * 8 + 4 * 4 + 10 * 14 + 8 + 3 + 12
    assert scaled.packed.numel() == 1 * 8 + 4 * 23 + 5 * 14 + 8 + 3 + 12


@pytest.mark.parametrize("name", ["caustics", "scaled"])
def test_agrees_with_the_port_bit_for_bit(name):
    """On the CPU the port's engine mega runs its plain K1: the frozen copy
    packs the same scene and sums the same bits."""
    from kajo_tpu_torch.models.integrator import RenderConfig
    from kajo_tpu_torch.ops import megakernel
    from kajo_tpu_torch.ops.rng import pass_seed
    from kajo_tpu_torch.scene import parser

    path = harness.HERE / "scenes" / f"{name}.json"
    port = parser.load(str(path), W / H, "cpu")
    rs = scene.load_packed(path, W / H, "cpu")
    assert torch.equal(megakernel.prepare_pass(port, W, H, SPP, RenderConfig()).packed, rs.packed)
    got = megakernel.render_passes_megakernel(port, 2**31 + 9, 8, W, H, SPP, 2, RenderConfig())
    want = walk.batch_image(rs, 2**31 + 9, 8, 2, W, H, SPP, walk.Estimator())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert [rng.pass_seed(2**31 + 9, p) for p in range(5)] == [pass_seed(2**31 + 9, p) for p in range(5)]


def test_stats_count_the_walk():
    rs = scene.load_packed(harness.HERE / "scenes" / "caustics.json", W / H, "cpu")
    stats = {}
    walk.batch_image(rs, 5, 0, 2, W, H, SPP, walk.Estimator(), stats=stats)
    assert set(stats) == set(walk.STATS)
    # every path ray hits (a closed room), every sample starts with one
    assert stats["hits"] == stats["rays"] >= 2 * W * H * SPP
    assert stats["shadow_rays"] == stats["lambert"] + stats["phong"] + stats["mirror"]  # one light


def test_control_differs():
    rs = scene.load_packed(harness.HERE / "scenes" / "caustics.json", W / H, "cpu")
    f32 = walk.batch_image(rs, 5, 0, 1, W, H, SPP, walk.Estimator())
    bf16 = walk.batch_image(rs, 5, 0, 1, W, H, SPP, walk.Estimator(), torch.bfloat16)
    assert bf16.dtype == torch.float32 and not torch.equal(f32, bf16)
