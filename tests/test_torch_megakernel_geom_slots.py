"""K4's slot rule against kajo_tpu's ``geometry_grads`` (Pallas interpret
mode), on the mirror cluster.

Past ``TRACK_SLOTS`` distinct non-light spheres a path's further spheres are
dropped: their records carry no tangent. At the kernels' count of 8 a path
needs ``max_depth`` >= 8 to overflow, the JAX kernel in interpret mode then
runs for minutes, and on the cluster the dropped spheres' share of the
gradient lies far below any bar a comparison of two float32 packages can
hold, so such a job could not tell the rule from its absence. Both packages
read the count when they build the walk (JAX when it traces the kernel, the
plain K4 when it runs), so here both run with ``TRACK_SLOTS = 2``: at
``max_depth=5`` many of the cluster's paths pass more than two mirrors and
still reach the ground's NEE term (their only radiance: with NEE on,
emission seen after a mirror does not count), the light's replay flag comes
after the two slots, and the rule moves the gradient by far more than the
bar. Bars: the port's centre and radius gradients within a relative
L2 gap of 1e-3 of JAX's, and the gradient without the rule (autodiff with
nothing detached) more than 10x the bar away.
"""

import numpy as np
import pytest
import torch
from torch_port import jax_grad_scene, jax_kernel_reference, rel_l2, to_port

from kajo_tpu_torch.models.integrator import RenderConfig
from kajo_tpu_torch.ops import megakernel, megakernel_geom

W, H, SPP = 16, 12, 4
KEY = 5
SLOTS = 2
CFG = dict(max_depth=5)


def cotangent():
    y = np.linspace(0.3, 1.0, H, dtype=np.float32)[:, None, None]
    x = np.linspace(1.0, 0.5, W, dtype=np.float32)[None, :, None]
    return np.broadcast_to(y * x, (H, W, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return jax_kernel_reference(
        tmp_path_factory.mktemp("jax_k4_slots"), "k4", {"cluster": ("mirror-cluster", CFG, {"track_slots": SLOTS})},
        W, H, SPP, KEY, {"cot": cotangent()}, cotangent="cot",
    )


def test_slot_rule_matches_jax(reference, monkeypatch):
    monkeypatch.setattr(megakernel_geom, "TRACK_SLOTS", SLOTS)
    scene = to_port(jax_grad_scene("mirror-cluster", W / H))
    cfg = RenderConfig(**CFG)
    seed = int(reference["cluster/seed"])
    cot = torch.tensor(cotangent())
    ps = megakernel.prepare_pass(scene, W, H, SPP, cfg)
    tracked = megakernel_geom.tracked_spheres(ps, seed, scene.light_indices)
    non_light = [i for i in range(scene.num_spheres) if i not in scene.light_indices]
    assert int(tracked[:, :, non_light].sum(-1).max()) == SLOTS
    got = megakernel_geom.geometry_grads(scene, seed, cot, W, H, SPP, cfg)
    assert megakernel_geom.kernel_launches == 0
    loose = megakernel_geom.scene_vjp_plain(scene, ("sphere_transform", "sphere_radius"), seed, cot, W, H, SPP, cfg)
    loose = {"center": loose["sphere_transform"][:, :3, 3], "radius": loose["sphere_radius"]}
    for k in ("center", "radius"):
        want = reference[f"cluster/{k}"]
        assert got[k].shape == want.shape and torch.isfinite(got[k]).all()
        gap, gap_loose = rel_l2(got[k].numpy(), want), rel_l2(loose[k].numpy(), want)
        print(f"{k}: relative L2 gap {gap:.3e}; without the slot rule {gap_loose:.3e}")
        assert gap <= 1e-3 and gap_loose > 1e-2, (k, gap, gap_loose)
