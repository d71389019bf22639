"""The port's material gradients against kajo_tpu's ``material_grads``
(Pallas interpret mode, same u32 seed and cotangent, 8x6, 4 spp,
``max_depth=3``) where the lights matter: the two-light scene with one-light
NEE, and ``random_spheres_scene(40, seed=11, extent=10, n_lights=2)``
(K = 43 objects: the Pallas kernel's VMEM-table path, which has no
counterpart in the port, whose table is one layout for every K). Bar as in
``test_torch_megakernel_grad.py``: relative L2 gap <= 1e-3 per field, all
finite. And, on the K = 43 scene, the emission gradient of a light equals
the same-seed central difference of the port's render (rtol 2e-3).
"""

import numpy as np
import pytest
import torch
from test_torch_megakernel_grad import (
    FH, FW, KEY, SPP, H, W, _grads, _mean, _scene, _with_mat, cotangent, hold_material_grads,
)
from torch_port import jax_kernel_reference

CASES = {
    "one-light": ("two-light", dict(max_depth=3, one_light_nee=True)),
    "random40": ("random40", dict(max_depth=3)),
}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return jax_kernel_reference(
        tmp_path_factory.mktemp("jax_k3_lights"), "k3", CASES, W, H, SPP, KEY, {"cot": cotangent()}, cotangent="cot"
    )


@pytest.mark.parametrize("case", CASES)
def test_material_grads_match_jax(case, reference):
    name, cfg = CASES[case]
    hold_material_grads(case, cfg, _scene(name), reference)


def test_many_objects_emission_grad_equals_same_seed_fd():
    scene = _scene("random40", FW, FH)
    assert scene.num_objects == 43
    li = scene.num_planes + scene.light_indices[0]
    gr = _grads(scene)
    h = 10.0
    fd = (_mean(_with_mat(scene, "emission", li, 1, h)) - _mean(_with_mat(scene, "emission", li, 1, -h))) / (2 * h)
    assert abs(fd) > 1e-7
    np.testing.assert_allclose(float(gr["emission"][li, 1]), fd, rtol=2e-3, atol=1e-9)
    assert torch.isfinite(gr["diffuse"]).all()
