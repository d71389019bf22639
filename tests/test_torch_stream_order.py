"""K5's and K6's exactness arguments, on the CPU (``kajo_tpu_torch/csrc/stream_trace.cu``):

  * a warp decides a block for four consecutive rays, which is exact only
    because a ray's answer depends on no other ray: the plain K5 on the
    rays in another order (reversed, random, sorted by direction octant),
    scattered back, equals the plain K5 on the rays as given, bit for bit,
    on a rigid and a general scene, with rays near the field and far
    outside it;
  * the superblock test (``_slab(..., superblock=True)``, the kernel's
    ``super_may_hit``) never rejects a ray-block pair that the block's own
    slab test admits at the same or a smaller bound, on seeded rays with
    zero and subnormal direction components, origins on box faces and
    origins 1e5 units out.

K6 (the any-hit test) goes further: the plain K6 on the rays in other
orders and on the blocks in other orders gives the same bits, so a ray may
stop at its first occluder and a warp once all its rays are occluded; and
on K6's own cuts the superblock test admits every block the block test
admits.

Small scenes, no JAX: the kernels themselves are held on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 7). Each scene is
prepared once for the module; each test draws its own rays."""

import numpy as np
import pytest
import torch

from kajo_tpu_torch.ops import geometry
from kajo_tpu_torch.ops import stream_trace as st
from kajo_tpu_torch.scene.procedural import random_spheres_scene

# one intra-op thread, as tests/torch_port.py sets for the other port files:
# pytest-xdist runs a process per core, and PyTorch's pool of a thread per
# core made this file's plain K5/K6 ~60x slower on a loaded 8-core CPU
torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[0.0, 0.5], ids=["rigid", "general"])
def prep(request):
    """The prepared 1500-sphere field, rigid or with ``scale_jitter=0.5``."""
    prep = geometry.prepare_scene(
        random_spheres_scene(1500, seed=4, extent=20.0, scale_jitter=request.param, device="cpu"))
    assert prep.stream_packed is not None and prep.stream_sboxes.shape == (2, 8)
    return prep


def _rays(prep, seed):
    """Primary rays, scattered rays inside the field and rays from 1e5
    units out aimed at it, with a mix of bounds."""
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.linspace(0.02, 0.98, 24), np.linspace(0.02, 0.98, 24))
    o_p, d_p = geometry.generate_rays(prep.camera, torch.tensor(xs.ravel(), dtype=torch.float32),
                                      torch.tensor(ys.ravel(), dtype=torch.float32))
    m = 600
    o_s = rng.uniform(-22, 22, (m, 3)).astype(np.float32)
    d_s = rng.normal(size=(m, 3)).astype(np.float32)
    far = rng.normal(size=(200, 3)).astype(np.float32)
    far = 1e5 * far / np.linalg.norm(far, axis=1, keepdims=True)
    d_f = (rng.uniform(-5, 5, (200, 3)) - far).astype(np.float32)
    o = torch.cat([o_p, torch.tensor(o_s), torch.tensor(far)])
    d = torch.cat([d_p, torch.tensor(d_s), torch.tensor(d_f)])
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    bound = torch.tensor(rng.uniform(1, 200, o.shape[0]).astype(np.float32))
    bound[::3] = st.BIG
    return o.contiguous(), d.contiguous(), bound


def test_answers_do_not_depend_on_ray_order(prep):
    o, d, bound = _rays(prep, seed=1)
    args = (prep.stream_packed, prep.stream_boxes, prep.stream_sboxes)
    t, idx = st.nearest_sphere_plain(prep.rigid, o, d, bound, *args)
    assert int((idx >= 0).sum()) > 200 and int((idx[-200:] >= 0).sum()) > 0  # far rays hit too
    n = o.shape[0]
    octant = ((d[:, 0] < 0).long() << 2) | ((d[:, 1] < 0).long() << 1) | (d[:, 2] < 0).long()
    orders = {"reversed": torch.arange(n - 1, -1, -1), "random": torch.tensor(np.random.default_rng(2).permutation(n)),
              "by octant": torch.argsort(octant, stable=True)}
    for label, perm in orders.items():
        t_p, idx_p = st.nearest_sphere_plain(prep.rigid, o[perm], d[perm], bound[perm], *args)
        t_back, idx_back = torch.empty_like(t_p), torch.empty_like(idx_p)
        t_back[perm], idx_back[perm] = t_p, idx_p
        assert torch.equal(idx_back, idx), label
        assert torch.equal(t_back.view(torch.int32), t.view(torch.int32)), label


def _hard_rays(boxes, n, seed):
    """Seeded rays against ``boxes``: origins inside the scene's box, on the
    faces of its blocks (exactly a block's lo or hi on one axis), and 1e5
    out; directions with components exactly 0 and subnormal (1/d overflows
    to inf, so 0 * inf gives NaN on a face)."""
    rng = np.random.default_rng(seed)
    b = boxes.numpy()
    lo, hi = b[:, 0:3].min(0), b[:, 3:6].max(0)
    o = rng.uniform(lo - 5, hi + 5, (n, 3)).astype(np.float32)
    face = rng.integers(0, n, n // 3)
    blk, ax = rng.integers(0, b.shape[0], face.size), rng.integers(0, 3, face.size)
    o[face, ax] = np.where(rng.random(face.size) < 0.5, b[blk, ax], b[blk, 3 + ax])
    out = rng.integers(0, n, n // 8)
    v = rng.normal(size=(out.size, 3))
    o[out] = (1e5 * v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    zero = rng.integers(0, n, n // 4)
    d[zero, rng.integers(0, 3, zero.size)] = 0.0
    tiny = rng.integers(0, n, n // 8)
    d[tiny, rng.integers(0, 3, tiny.size)] = np.float32(1e-40) * rng.choice([-1, 1], tiny.size)
    both = rng.integers(0, n, n // 16)
    d[both, 0] = 0.0
    d[both, 1] = 0.0
    d[both, 2] = 1.0
    return torch.tensor(o), torch.tensor(d)


def test_superblock_never_rejects_an_admitted_block(prep):
    boxes, sboxes = prep.stream_boxes, prep.stream_sboxes
    per = st.V2_SUPER // st.BLOCK
    o, d = _hard_rays(boxes, 6000, seed=3)
    t_b, entered_b = st._slab(o, d, boxes)
    t_s, entered_s = st._slab(o, d, sboxes, superblock=True)
    member = torch.arange(boxes.shape[0]) // per
    t_s, entered_s = t_s[:, member], entered_s[:, member]  # each block's superblock
    rng = np.random.default_rng(5)
    bound = torch.tensor(rng.choice([0.0, 0.5, 5.0, 50.0, 500.0, st.BIG], o.shape[0]).astype(np.float32))[:, None]
    later = bound * torch.tensor(rng.uniform(0, 1, (o.shape[0], 1)).astype(np.float32))  # t_best falls later
    for t_block in (bound, later):
        admitted = entered_b & (t_b * boxes[:, 6] < t_block)
        assert int(admitted.sum()) > 1000
        assert bool((entered_s & (t_s * sboxes[member, 6] < bound))[admitted].all())
    # the superblock's interval contains the block's wherever the block admits
    admitted = entered_b & (t_b * boxes[:, 6] < bound)
    assert bool((t_s <= t_b)[admitted].all())


def test_superblock_nan_axis_constrains_nothing():
    """A subnormal direction component and an origin on the superblock's
    face give 0 * inf = NaN on that axis: the axis constrains nothing, where
    the block test's fminf/fmaxf would drop the NaN."""
    sbox = torch.tensor([[0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 1.0, 0.0]])
    o = torch.tensor([[1.0, 0.5, 0.5], [0.0, 0.5, 0.5]])
    d = torch.tensor([[1e-40, 0.0, 1.0], [-1e-40, 0.0, 1.0]])
    t_loose, entered_loose = st._slab(o, d, sbox, superblock=True)
    assert bool(entered_loose.all()) and bool((t_loose == 0).all())
    assert not bool(st._slab(o, d, sbox)[1].any())  # the block test's rule rejects both


# ---- K6: an any-hit answer, which no ray order and no block order changes


def _shadow_args(prep, seed):
    """K6's inputs on ``_rays``: cuts at 1.5x each ray's nearest hit (so
    most hit rays are occluded by the sphere they hit), the bound where it
    missed, zero on every seventh ray; on every other ray the nearest hit's
    own packed row excluded, as a shadow query excludes its light."""
    o, d, bound = _rays(prep, seed)
    t, idx = st.nearest_sphere_plain(prep.rigid, o, d, bound, prep.stream_packed, prep.stream_boxes)
    cut = torch.where(idx >= 0, t * 1.5, bound)
    cut[::7] = 0.0
    excl = torch.where(torch.arange(o.shape[0]) % 2 == 0, idx, -1).to(torch.int32)
    return o, d, cut, excl


def test_occlusion_does_not_depend_on_ray_order(prep):
    o, d, cut, excl = _shadow_args(prep, seed=6)
    args = (prep.stream_packed, prep.stream_boxes, prep.stream_sboxes)
    out = st.occluded_sphere_plain(prep.rigid, o, d, cut, excl, *args)
    occluded = out == 0
    assert 200 < int(occluded.sum()) < o.shape[0] - 200
    n = o.shape[0]
    for label, perm in {"reversed": torch.arange(n - 1, -1, -1),
                        "random": torch.tensor(np.random.default_rng(8).permutation(n))}.items():
        got = st.occluded_sphere_plain(prep.rigid, o[perm], d[perm], cut[perm], excl[perm], *args)
        back = torch.empty_like(got)
        back[perm] = got
        assert torch.equal(back.view(torch.int32), out.view(torch.int32)), label


def test_occlusion_does_not_depend_on_block_order(prep):
    """The packed blocks (records, boxes and the excluded rows with them)
    visited in reversed and in a random order: the same bits on every ray,
    which is what lets K6 stop a ray at its first occluder and test a
    superblock before its blocks."""
    o, d, cut, excl = _shadow_args(prep, seed=9)
    packed, boxes = prep.stream_packed, prep.stream_boxes
    out = st.occluded_sphere_plain(prep.rigid, o, d, cut, excl, packed, boxes)
    n_blocks = boxes.shape[0]
    rng = np.random.default_rng(10)
    for label, order in {"reversed": torch.arange(n_blocks - 1, -1, -1),
                         "random": torch.tensor(rng.permutation(n_blocks))}.items():
        packed_p = packed.view(n_blocks, st.BLOCK, -1)[order].reshape(packed.shape)
        new_block = torch.empty_like(order)
        new_block[order] = torch.arange(n_blocks)  # where each old block goes
        excl_p = torch.where(excl >= 0, new_block[excl.clamp_min(0).long() // st.BLOCK] * st.BLOCK
                             + excl.clamp_min(0) % st.BLOCK, -1).to(torch.int32)
        got = st.occluded_sphere_plain(prep.rigid, o, d, cut, excl_p, packed_p, boxes[order].contiguous())
        assert torch.equal(got.view(torch.int32), out.view(torch.int32)), label


def test_superblock_admits_every_block_k6_tests(prep):
    """On K6's own inputs: wherever a block's box test admits a ray at its
    cut (the only bound K6 tests a block against before the ray is
    occluded), the block's superblock test admits it too."""
    o, d, cut, _ = _shadow_args(prep, seed=12)
    boxes, sboxes = prep.stream_boxes, prep.stream_sboxes
    member = torch.arange(boxes.shape[0]) // (st.V2_SUPER // st.BLOCK)
    t_b, entered_b = st._slab(o, d, boxes)
    t_s, entered_s = st._slab(o, d, sboxes, superblock=True)
    admitted = entered_b & (t_b * boxes[:, 6] < cut[:, None])
    assert int(admitted.sum()) > 500
    assert bool((entered_s & (t_s * sboxes[:, 6] < cut[:, None]))[:, member][admitted].all())
