"""The port's sphere geometry gradients (K4's plain version, as the CPU runs
it) against kajo_tpu's ``geometry_grads`` in Pallas interpret mode, same u32
seed and cotangent, at 16x12, 4 spp, ``max_depth=2``, on caustics (rigid
record) and ``scaled.json`` (general record). The JAX side runs once, in a
subprocess, on the port's packed scene with XLA's multiply-add fusion off
(``tests/torch_port.py:jax_grad_reference``). Bar: relative L2 gap <= 1e-3
for the centre and the radius gradients, all finite.

The port's own checks: every sphere's centre and radius gradient equals the
forward-mode directional derivative (K2's plain version) contracted with
the cotangent (the pattern of ``test_center_grads_match_forward_mode``, to
5e-4 of the summed terms' magnitude), light spheres included; a light centre's gradient equals the
same-seed central difference of the render where no silhouette moves
(rtol 0.01); the slot rule past ``TRACK_SLOTS``; and the reference's limit
of 31 lights with NEE, kept as a ValueError.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_port import jax_grad_scene, jax_kernel_reference, rel_l2, to_port

from kajo_tpu_torch.models.integrator import RenderConfig
from kajo_tpu_torch.ops import megakernel, megakernel_geom
from kajo_tpu_torch.ops.megakernel import render_pass_megakernel, render_pass_megakernel_jvp, scene_zero_tangent
from kajo_tpu_torch.scene.procedural import random_spheres_scene
from kajo_tpu_torch.scene.testscene import build_mirror_cluster

W, H, SPP = 16, 12, 4
KEY = 3
CFG = dict(max_depth=2)
CASES = {"caustics": ("caustics.json", CFG), "scaled": ("scaled.json", CFG)}


def _scene(name):
    return to_port(jax_grad_scene(name, W / H))


def cotangent():
    """Non-uniform, so the per-pixel sign structure is exercised."""
    y = np.linspace(0.2, 1.0, H, dtype=np.float32)[:, None, None]
    x = np.linspace(1.0, 0.4, W, dtype=np.float32)[None, :, None]
    return np.broadcast_to(y * x, (H, W, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return jax_kernel_reference(
        tmp_path_factory.mktemp("jax_k4"), "k4", CASES, W, H, SPP, KEY, {"cot": cotangent()}, cotangent="cot"
    )


@pytest.mark.parametrize("case", CASES)
def test_geometry_grads_match_jax(case, reference):
    name, cfg = CASES[case]
    got = megakernel_geom.geometry_grads(
        _scene(name), int(reference[f"{case}/seed"]), torch.tensor(cotangent()), W, H, SPP, RenderConfig(**cfg)
    )
    assert megakernel_geom.kernel_launches == 0  # the CPU runs the plain version
    assert set(got) == {"center", "radius"}
    for k, v in got.items():
        want = reference[f"{case}/{k}"]
        assert v.shape == want.shape and torch.isfinite(v).all(), k
        gap = rel_l2(v.numpy(), want)
        print(f"{case} {k}: relative L2 gap {gap:.3e}")
        assert gap <= 1e-3, (k, gap)


@pytest.mark.parametrize("name", ["caustics.json", "scaled.json"])
def test_geometry_grads_equal_forward_mode(name):
    """Reverse and forward mode sum the same per-pixel terms in another
    order of float32 operations: through caustics' glass ball single lanes
    part by up to 1e-4 relative, and a centre gradient that is a small sum
    of large terms of both signs (0.229 from terms of +-7) moves by 0.4%.
    So the bar is on the terms' scale: |rev - fwd| <= 5e-4 sum|cot * d
    image| + 1e-5."""
    scene = _scene(name)
    cfg = RenderConfig(**CFG)
    cot = torch.tensor(cotangent())
    rev = megakernel_geom.geometry_grads(scene, 7, cot, W, H, SPP, cfg)
    lights = set(scene.light_indices)
    for i in range(scene.num_spheres):
        for field, index, got in [("sphere_radius", (i,), rev["radius"][i])] + [
            ("sphere_transform", (i, ax, 3), rev["center"][i, ax]) for ax in range(3)
        ]:
            tan = scene_zero_tangent(scene)
            getattr(tan, field)[index] = 1.0
            _, img_dot = render_pass_megakernel_jvp(scene, tan, 7, W, H, SPP, cfg)
            terms = cot * img_dot[..., :3]
            want = float(terms.sum())
            assert abs(float(got) - want) <= 5e-4 * float(terms.abs().sum()) + 1e-5, (field, index, float(got), want)
    assert lights and rev["center"][sorted(lights)].abs().sum() > 0  # the NEE sampler's role is differentiated
    assert rev["center"].abs().sum() > 0 and rev["radius"].abs().sum() > 0


def test_light_center_grad_equals_same_seed_fd():
    """Pixels where the difference blows up (a silhouette crossing) are left
    out of the cotangent, so interior gradient meets interior difference."""
    scene = _scene("caustics.json")
    cfg = RenderConfig(**CFG)
    li = scene.light_indices[0]

    def prim(dz):
        st = scene.sphere_transform.clone()
        st[li, 2, 3] += dz
        return render_pass_megakernel(dataclasses.replace(scene, sphere_transform=st), 11, W, H, SPP, cfg)[..., :3]

    h = 1e-3
    fd = (prim(h) - prim(-h)) / (2 * h)
    cot = (fd.abs() < 50).all(-1, keepdim=True).expand(H, W, 3).to(torch.float32)
    want = float((fd * cot).sum())
    got = float(megakernel_geom.geometry_grads(scene, 11, cot, W, H, SPP, cfg)["center"][li, 2])
    assert abs(want) > 1e-3
    np.testing.assert_allclose(got, want, rtol=0.01)


def test_slot_rule_past_track_slots():
    """On the mirror cluster at ``max_depth=20`` some samples hit more than
    TRACK_SLOTS distinct spheres: the plain K4 tracks the first 8 per lane
    and sample (and every light with NEE on) and detaches the rest, as the
    kernel drops them, which changes the gradient."""
    scene = build_mirror_cluster(4 / 3, device="cpu")
    cfg = RenderConfig(max_depth=20)
    w, h, spp = 8, 6, 1
    ps = megakernel.prepare_pass(scene, w, h, spp, cfg)
    tracked = megakernel_geom.tracked_spheres(ps, 3, scene.light_indices)
    non_light = [i for i in range(scene.num_spheres) if i not in scene.light_indices]
    per_sample = tracked[:, :, non_light].sum(-1)
    assert per_sample.max() == megakernel_geom.TRACK_SLOTS
    assert tracked[:, :, list(scene.light_indices)].all()
    cot = torch.ones((h, w, 3))
    got = megakernel_geom.geometry_grads(scene, 3, cot, w, h, spp, cfg)
    untracked = megakernel_geom.scene_vjp_plain(scene, ("sphere_transform",), 3, cot, w, h, spp, cfg)
    assert torch.isfinite(got["center"]).all() and torch.isfinite(got["radius"]).all()
    assert not torch.allclose(got["center"], untracked["sphere_transform"][:, :3, 3])


def test_nee_light_limit():
    """The reference's per-light replay mask is an int32 (``1 << li``), so
    with NEE on it cannot trace 32 lights or more; the port keeps the limit
    and says so."""
    scene = random_spheres_scene(40, seed=2, extent=10.0, n_lights=32, device="cpu")
    assert scene.num_lights == 32
    nee, no_nee = RenderConfig(max_depth=2), RenderConfig(max_depth=2, direct_lighting=False)
    assert not megakernel_geom.supports(scene, nee) and megakernel_geom.supports(scene, no_nee)
    cot = torch.ones((3, 4, 3))
    with pytest.raises(ValueError, match="31 lights"):
        megakernel_geom.geometry_grads(scene, 1, cot, 4, 3, 1, nee)
    assert torch.isfinite(megakernel_geom.geometry_grads(scene, 1, cot, 4, 3, 1, no_nee)["center"]).all()
    few = random_spheres_scene(40, seed=2, extent=10.0, n_lights=31, device="cpu")
    assert megakernel_geom.supports(few, nee)
