"""The port's streaming trace against kajo_tpu's V4 kernels, bit for bit.

The JAX side (``tests/_jax_stream_ref.py``) runs in subprocesses with the
XLA CPU instruction set capped at SSE4.2, so XLA fuses no multiply-add and
every float rounds as in the port's plain versions; its V4 kernels run in
Pallas interpret mode with ``geometry.FORCE_STREAM``. Scene:
``random_spheres_scene(1500, seed=4, extent=20)``, rigid and with
``scale_jitter=0.6``; rays: 32 x 24 primary and as many scattered ones.

  * ``morton_order`` and ``build_stream_scene`` (packed, boxes, perm) equal
    kajo_tpu's exactly. For the general record the port is handed JAX's
    inverses, determinants and camera origin: those come from two LAPACK
    builds, and the test is of the packing;
  * ``nearest_sphere_plain`` (K5's function) gives the same winner on every
    ray and the same t to the bit; ``occluded_sphere_plain`` (K6's) the same
    answer on every ray, with half the rays excluding their own nearest
    sphere.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_port import jax_script_reference

from kajo_tpu_torch.ops import geometry, stream_trace
from kajo_tpu_torch.scene.procedural import random_spheres_scene

CASES = ("rigid", "jitter")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return jax_script_reference(tmp_path_factory.mktemp("jax_stream_ref"), "_jax_stream_ref.py", CASES)


def _port_prep(case, ref):
    scene = random_spheres_scene(1500, seed=4, extent=20.0, scale_jitter=0.6 if case == "jitter" else 0.0, device="cpu")
    prep = geometry.prepare_scene(scene)
    fix = dict(camera=dataclasses.replace(prep.camera, origin=torch.tensor(ref["camera_origin"])))
    if case == "jitter":
        fix.update({k: torch.tensor(ref[k]) for k in ("sphere_inv3", "sphere_invt", "sphere_det")})
    return dataclasses.replace(prep, **fix)


def _rays(ref):
    return torch.tensor(ref["o"]), torch.tensor(ref["d"])


@pytest.mark.parametrize("case", CASES)
def test_build_stream_scene_bit_equal(case, reference):
    ref = reference[case]
    prep = _port_prep(case, ref)
    assert prep.rigid == (case == "rigid")
    np.testing.assert_array_equal(stream_trace.morton_order(prep.sphere_center).numpy(), ref["morton"])
    packed, boxes, sperm, inv_perm, sboxes = stream_trace.build_stream_scene(prep)
    assert packed.dtype == boxes.dtype == torch.float32
    # K5's superblocks: a field of its own beside those kajo_tpu's V4 builds
    assert torch.equal(sboxes, stream_trace.v2_superblocks(boxes))
    np.testing.assert_array_equal(packed.numpy().view(np.int32), ref["packed"].view(np.int32))
    np.testing.assert_array_equal(boxes.numpy().view(np.int32), ref["boxes"].view(np.int32))
    np.testing.assert_array_equal(sperm.numpy(), ref["perm"])
    # inv_perm sends every sphere to its own packed row, never to a pad row
    # (r2 == -1 in the rigid record's last column, the general's next to last)
    n = prep.sphere_center.shape[0]
    assert inv_perm.dtype == torch.int32 and inv_perm.shape == (n,)
    np.testing.assert_array_equal(sperm.numpy()[inv_perm.numpy()], np.arange(n))
    assert (packed[inv_perm.long(), -1 if case == "rigid" else -2] >= 0).all()


@pytest.mark.parametrize("case", CASES)
def test_nearest_plain_matches_v4(case, reference):
    ref = reference[case]
    prep = dataclasses.replace(
        _port_prep(case, ref),
        stream_packed=torch.tensor(ref["packed"]),
        stream_boxes=torch.tensor(ref["boxes"]),
        stream_perm=torch.tensor(ref["perm"]).long(),
    )
    o, d = _rays(ref)
    t, idx = stream_trace.nearest_sphere(prep, o, d, torch.tensor(ref["t_max"]))
    assert stream_trace.nearest_launches == 0  # the CPU runs the plain version
    hits = idx >= 0
    assert 200 < int(hits.sum()) < o.shape[0] - 200
    np.testing.assert_array_equal(idx.numpy(), ref["idx_near"])
    np.testing.assert_array_equal(t.numpy().view(np.int32), ref["t_near"].view(np.int32))


@pytest.mark.parametrize("case", CASES)
def test_occluded_plain_matches_v4(case, reference):
    ref = reference[case]
    prep = dataclasses.replace(
        _port_prep(case, ref), stream_packed=torch.tensor(ref["packed"]), stream_boxes=torch.tensor(ref["boxes"])
    )
    o, d = _rays(ref)
    occ = stream_trace.occluded_sphere(prep, o, d, torch.tensor(ref["t_cut"]), torch.tensor(ref["excl"]))
    assert stream_trace.occluded_launches == 0
    assert 200 < int(occ.sum()) < o.shape[0] - 200
    np.testing.assert_array_equal(occ.numpy(), ref["occluded"])
    # the exclusion matters: without it, rays cut beyond their own nearest sphere are occluded by it
    excl = torch.tensor(ref["excl"]) >= 0
    occ_all = stream_trace.occluded_sphere(prep, o, d, torch.tensor(ref["t_cut"]))
    assert (occ_all & ~occ & excl).any() and not (occ & ~occ_all).any()


def test_stream_trace_refuses_other_devices():
    """A CPU tensor takes the plain version; a tensor on another device
    than CPU or CUDA is refused rather than computed somewhere else."""
    prep = geometry.prepare_scene(random_spheres_scene(1100, seed=1, extent=10.0, device="cpu"))
    assert prep.stream_packed is not None and prep.stream_packed.shape == (1152, 4)
    o = torch.zeros((4, 3))
    d = torch.tensor([[1.0, 0.0, 0.0]]).expand(4, 3)
    with pytest.raises(ValueError, match="device"):
        stream_trace.nearest_sphere(prep, o.to("meta"), d.to("meta"))
