"""The port's forward mode of a megakernel pass (K2's plain version, as the
CPU runs it) against kajo_tpu's ``render_pass_megakernel_jvp`` in Pallas
interpret mode, same u32 seed, at 16x12, 4 spp, ``max_depth=2``: a sphere's
radius tangent and a sphere centre's tangent, on caustics (rigid record)
and ``scaled.json`` (general record). The JAX side runs once, in a
subprocess, on the port's packed scene with XLA's multiply-add fusion off
(``tests/torch_port.py:jax_grad_reference``). Bar: relative L2 gap of the
tangent image <= 1e-3, all finite.

The port's own checks: the primal equals its ``render_pass_megakernel``
bit for bit; a material tangent, summed over the image, equals the material
gradient (the pattern of ``test_jvp_kernel_material_tangent``, rtol 1e-3),
also where the perturbed channel moves the coin probabilities (the
detached convention); ``safe_sqrt`` and ``safe_pow`` have JAX's clamped
derivatives in both modes.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD
from torch_port import jax_grad_reference, jax_grad_scene, port_packed, rel_l2, to_port

from kajo_tpu_torch.models.integrator import RenderConfig
from kajo_tpu_torch.ops import megakernel, megakernel_grad
from kajo_tpu_torch.ops.megakernel import render_pass_megakernel, render_pass_megakernel_jvp, scene_zero_tangent

W, H, SPP = 16, 12, 4
KEY = 3
CFG = dict(max_depth=2)
CASES = {"caustics": ("caustics.json", CFG), "scaled": ("scaled.json", CFG)}
# (tangent name, scene field, index set to 1)
TANGENTS = {
    "caustics": {"radius": ("sphere_radius", (0,)), "centre": ("sphere_transform", (2, 0, 3))},
    "scaled": {"radius": ("sphere_radius", (2,)), "centre": ("sphere_transform", (1, 1, 3))},
}


def _scene(name, w=W, h=H):
    return to_port(jax_grad_scene(name, w / h))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    arrays, jobs = {}, []
    for case, (name, cfg) in CASES.items():
        arrays[f"packed/{name}"] = port_packed(_scene(name))
        tangents = {t: [[field, list(index)]] for t, (field, index) in TANGENTS[case].items()}
        jobs.append(dict(name=case, kind="k2", scene=name, w=W, h=H, spp=SPP, config=cfg, key=KEY, tangents=tangents))
    return jax_grad_reference(tmp_path_factory.mktemp("jax_k2"), jobs, arrays)


@pytest.mark.parametrize("case,tangent", [(c, t) for c in CASES for t in ("radius", "centre")])
def test_tangent_matches_jax(case, tangent, reference):
    name, cfg = CASES[case]
    scene = _scene(name)
    field, index = TANGENTS[case][tangent]
    tan = scene_zero_tangent(scene)
    getattr(tan, field)[index] = 1.0
    seed = int(reference[f"{case}/seed"])
    img, img_dot = render_pass_megakernel_jvp(scene, tan, seed, W, H, SPP, RenderConfig(**cfg))
    assert megakernel.jvp_launches == 0  # the CPU runs the plain version
    want = reference[f"{case}/{tangent}"][..., :3]
    got = img_dot[..., :3].numpy()
    assert np.isfinite(got).all() and np.isfinite(img.numpy()).all()
    assert np.abs(want).sum() > 1e-3  # a real signal
    gap = rel_l2(got, want)
    print(f"{case} {tangent}: relative L2 gap {gap:.3e}")
    assert gap <= 1e-3
    assert (img_dot[..., 3] == 0).all()


@pytest.mark.parametrize("name", ["caustics.json", "scaled.json"])
def test_primal_equals_render(name):
    scene = _scene(name)
    cfg = RenderConfig(**CFG)
    tan = scene_zero_tangent(scene)
    tan.sphere_transform[0, 1, 3] = 1.0
    img, _ = render_pass_megakernel_jvp(scene, tan, 17, W, H, SPP, cfg)
    want = render_pass_megakernel(scene, 17, W, H, SPP, cfg)
    assert torch.equal(img.view(torch.int32), want.view(torch.int32))


def _two_light(mixed: bool):
    """The two-light scene; ``mixed`` gives its second sphere (material 3,
    a mirror) diffuse (0.5, 0.3, 0.2) besides a specular lobe, so its
    diffuse red channel, the largest, moves the coin probabilities."""
    scene = _scene("two-light")
    if not mixed:
        return scene
    m = scene.materials
    diffuse, specular, expo = m.diffuse.clone(), m.specular.clone(), m.specular_exponent.clone()
    diffuse[3, :3] = torch.tensor([0.5, 0.3, 0.2])
    specular[3, :3] = 0.3
    expo[3] = 40.0
    mats = dataclasses.replace(m, diffuse=diffuse, specular=specular, specular_exponent=expo)
    return dataclasses.replace(scene, materials=mats)


@pytest.mark.parametrize("mixed,k,ch", [(False, 2, 1), (True, 3, 0)], ids=["pure-diffuse", "detached-coins"])
def test_material_tangent_equals_material_gradient(mixed, k, ch):
    scene = _two_light(mixed)
    cfg = RenderConfig(**CFG)
    tan = scene_zero_tangent(scene)
    tan.materials.diffuse[k, ch] = 1.0
    _, img_dot = render_pass_megakernel_jvp(scene, tan, 5, W, H, SPP, cfg)
    gr = megakernel_grad.material_grads(scene, 5, torch.ones((H, W, 3)), W, H, SPP, cfg)
    a, b = float(img_dot[..., :3].sum()), float(gr["diffuse"][k, ch])
    assert abs(a) > 1e-3
    np.testing.assert_allclose(a, b, rtol=1e-3)


def _both_modes(fn, *xs):
    """(reverse-mode gradients, forward-mode derivative along ones)."""
    leaves = [x.clone().requires_grad_(True) for x in xs]
    rev = torch.autograd.grad(fn(*leaves).sum(), leaves)
    with fwAD.dual_level():
        out = fn(*(fwAD.make_dual(x, torch.ones_like(x)) for x in xs))
        fwd = fwAD.unpack_dual(out).tangent
    return rev, fwd


def test_safe_sqrt_derivative_is_clamped():
    x = torch.tensor([-1.0, 0.0, 1e-30, 4.0])
    (rev,), fwd = _both_modes(megakernel._safe_sqrt, x)
    want = torch.tensor([0.0, 0.0, 0.5 / 1e-6, 0.25])  # 0.5 rsqrt(max(x, 1e-12)) for x > 0
    torch.testing.assert_close(rev, want)
    torch.testing.assert_close(fwd, want)
    assert torch.equal(megakernel._safe_sqrt(x), torch.tensor([0.0, 0.0, 1e-15, 2.0]))


def test_safe_pow_derivative_is_underflow_safe():
    x = torch.tensor([-1.0, 0.0, 0.5, 1e-30, 2.0])
    n = torch.tensor([3.0, 0.0, 40.0, 200.0, 2.0])
    (dx, dn), fwd = _both_modes(megakernel._safe_pow, x, n)
    assert torch.isfinite(dx).all() and torch.isfinite(dn).all()
    torch.testing.assert_close(dx, torch.tensor([0.0, 0.0, 40.0 * 0.5**39, 0.0, 4.0]))
    torch.testing.assert_close(dn, torch.tensor([0.0, 0.0, 0.5**40 * np.log(0.5), 0.0, 4.0 * np.log(2.0)]).float())
    torch.testing.assert_close(fwd, dx + dn)
    assert torch.equal(megakernel._safe_pow(x, n)[:2], torch.tensor([0.0, 1.0]))
