"""The port's material gradients (K3's plain version, as the CPU runs it)
against kajo_tpu's ``material_grads`` in Pallas interpret mode, same u32
seed and cotangent, at 8x6, 4 spp, ``max_depth=3``: caustics (rigid
record) and ``scaled.json`` (general record); the lights' cases are in
``test_torch_megakernel_grad_lights.py``.

The JAX side runs once, in a subprocess (``tests/torch_port.py:
jax_grad_reference``) on the port's packed scene with XLA's multiply-add
fusion off. Bar: every field within a relative L2 gap of 1e-3, all finite.

The port's own checks: the emission and background gradients equal the
same-seed central differences of its render (both enter the estimator
linearly, rtol 2e-3); a diffuse gradient equals them where no coin moves
(rtol 0.05, the pattern of ``test_diffuse_grad_close``: a missing detach of
a coin probability shows here); ``make_diff_renderer``'s gradients are
finite, non-zero and 0 for alpha and the rotation part of a transform.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_port import jax_grad_scene, jax_kernel_reference, rel_l2, to_port

from kajo_tpu_torch.models.integrator import RenderConfig
from kajo_tpu_torch.ops import megakernel, megakernel_grad
from kajo_tpu_torch.ops.megakernel import render_pass_megakernel

W, H, SPP = 8, 6, 4
KEY = 3
CASES = {
    "caustics": ("caustics.json", dict(max_depth=3)),
    "scaled": ("scaled.json", dict(max_depth=3)),
}
FIELDS = ("diffuse", "specular", "emission", "background")


def _scene(name, w=W, h=H):
    return to_port(jax_grad_scene(name, w / h))


def cotangent():
    return np.random.default_rng(0).uniform(0.0, 1.0, (H, W, 3)).astype(np.float32)


def hold_material_grads(case, cfg, scene, ref):
    """The port's material_grads on the reference's seed and cotangent
    against the JAX fields."""
    before = megakernel_grad.kernel_launches
    got = megakernel_grad.material_grads(
        scene, int(ref[f"{case}/seed"]), torch.tensor(cotangent()), W, H, SPP, RenderConfig(**cfg)
    )
    assert megakernel_grad.kernel_launches == before  # the CPU runs the plain version
    assert set(got) == set(FIELDS)
    for k in FIELDS:
        want = ref[f"{case}/{k}"]
        g = got[k].numpy()
        assert g.shape == want.shape and np.isfinite(g).all(), k
        if not np.abs(want).any():
            assert not np.abs(g).any(), k
            continue
        gap = rel_l2(g, want)
        print(f"{case} {k}: relative L2 gap {gap:.3e}")
        assert gap <= 1e-3, (k, gap)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return jax_kernel_reference(
        tmp_path_factory.mktemp("jax_k3"), "k3", CASES, W, H, SPP, KEY, {"cot": cotangent()}, cotangent="cot"
    )


@pytest.mark.parametrize("case", CASES)
def test_material_grads_match_jax(case, reference):
    name, cfg = CASES[case]
    hold_material_grads(case, cfg, _scene(name), reference)


# ---- the port against its own render ---------------------------------------
FW, FH = 16, 12
CFG = RenderConfig(max_depth=3)


def _mean(scene, seed=5, cfg=CFG):
    return float(render_pass_megakernel(scene, seed, FW, FH, SPP, cfg)[..., :3].mean())


def _grads(scene, seed=5, cfg=CFG):
    g = torch.full((FH, FW, 3), 1.0 / (FH * FW * 3))
    return megakernel_grad.material_grads(scene, seed, g, FW, FH, SPP, cfg)


def _with_mat(scene, field, idx, ch, dv):
    arr = getattr(scene.materials, field).clone()
    arr[idx, ch] += dv
    return dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, **{field: arr}))


def test_emission_grad_equals_same_seed_fd():
    """Emission enters the estimator linearly and steers no coin or
    direction: its gradient is the same-seed difference."""
    scene = _scene("caustics.json", FW, FH)
    li = scene.num_planes + scene.light_indices[0]
    gr = _grads(scene)
    h = 10.0
    fd = (_mean(_with_mat(scene, "emission", li, 1, h)) - _mean(_with_mat(scene, "emission", li, 1, -h))) / (2 * h)
    assert abs(fd) > 1e-6
    np.testing.assert_allclose(float(gr["emission"][li, 1]), fd, rtol=2e-3)


def test_background_grad_equals_same_seed_fd():
    scene = _scene("two-light", FW, FH)
    gr = _grads(scene)
    h = 0.5

    def with_bg(dv):
        return dataclasses.replace(scene, background=scene.background + torch.tensor([0.0, dv, 0.0, 0.0]))

    fd = (_mean(with_bg(h)) - _mean(with_bg(-h))) / (2 * h)
    assert abs(fd) > 1e-6
    np.testing.assert_allclose(float(gr["background"][1]), fd, rtol=2e-3)


def test_diffuse_grad_close_to_same_seed_fd():
    """The green channel of the first sphere of the two-light scene (0.7,
    0.3, 0.2; no specular): below its max channel, so no coin moves with a
    small change, and the detached convention's gradient is the same-seed
    difference."""
    scene = _scene("two-light", FW, FH)
    k = scene.num_planes
    gr = _grads(scene)
    h = 5e-3
    fd = (_mean(_with_mat(scene, "diffuse", k, 1, h)) - _mean(_with_mat(scene, "diffuse", k, 1, -h))) / (2 * h)
    assert abs(fd) > 1e-4
    np.testing.assert_allclose(float(gr["diffuse"][k, 1]), fd, rtol=0.05, atol=1e-5)


@pytest.mark.parametrize("geometry", [False, True], ids=["materials", "geometry"])
def test_diff_renderer_gradients(geometry):
    scene = _scene("scaled.json", FW, FH)
    render = megakernel_grad.make_diff_renderer(FW, FH, SPP, CFG, geometry=geometry)
    names = ("diffuse", "background") + (("sphere_transform", "sphere_radius") if geometry else ())
    leaves = {n: megakernel_grad.leaf(scene, n).clone().requires_grad_(True) for n in names}
    img = render(megakernel_grad.with_leaves(scene, leaves), 9)
    torch.testing.assert_close(img, render_pass_megakernel(scene, 9, FW, FH, SPP, CFG), rtol=0, atol=0)
    grads = torch.autograd.grad(img[..., :3].mean(), list(leaves.values()))
    g = dict(zip(names, grads))
    for n, v in g.items():
        assert torch.isfinite(v).all() and v.abs().sum() > 0, n
    assert (g["diffuse"][:, 3] == 0).all() and g["background"][3] == 0  # alpha receives nothing
    if geometry:
        rest = g["sphere_transform"].clone()
        rest[:, :3, 3] = 0
        assert not rest.any()  # only the translation column
    assert megakernel.kernel_launches == 0 and megakernel_grad.kernel_launches == 0
