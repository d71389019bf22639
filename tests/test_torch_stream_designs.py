"""The port's V1, V2 and V3 nearest-hit designs (K7, K8, K9: their plain
versions on the CPU) against kajo_tpu's, bit for bit.

The JAX side (``tests/_jax_stream_designs_ref.py``) runs in one subprocess
per scene, with the XLA CPU instruction set capped at SSE4.2 so XLA fuses
no multiply-add, its kernels in Pallas interpret mode under each flag set:
V1 (packed, frustum and near-to-far order), V2 and V3 on
``random_spheres_scene(1500, seed=4, extent=20)`` rigid, V1, V2 and V3 with
``scale_jitter=0.6``; rays: 32 x 24 primary and as many scattered ones,
half of them bounded. The port runs on kajo_tpu's packing (its equality
with the port's own is ``test_torch_stream_trace.py``'s).

  * every design gives kajo_tpu's winner on every ray and its t to the bit,
    at the port's tiles and, for V1's orders, at kajo_tpu's 4096-ray tile;
    and K5's answer (the port's ``nearest_sphere_plain``), as these rays lie
    in the field;
  * V2 and V3 on one 512-ray tile from 1e5-1e6 units out
    (``stream_far_rays.far_rays``), where the tile vote decides the
    answer: kajo_tpu's winner and t to the bit, and on some ray a winner
    unlike K5's, so a design that dropped the vote fails;
  * ``frustum_candidates`` equals kajo_tpu's ``_frustum_candidates`` as
    integers (kajo_tpu's tail repeats of the last candidate aside);
  * the det-scaled adversarial scene of ``test_bigscene.py``: the far,
    small-det cluster wins under every design, as in the dense trace;
  * dispatch: the setting, its context manager and ``design=``; V3 over the
    residency cap runs V1; an unknown name raises; a streamed wavefront pass
    under each design stays within the bars of the K5 pass;
  * V1's vote is monotone (what K7's batched votes rest on): a block that a
    tile's vote refuses at the rays' starting bounds is never scanned, so
    lists cut to the blocks admitted there give the same bits.
"""

import types

import numpy as np
import pytest
import torch
from torch_port import jax_script_reference, mean_rel, tm_mad

from kajo_tpu_torch.models import wavefront
from kajo_tpu_torch.models.integrator import RenderConfig
from kajo_tpu_torch.ops import geometry
from kajo_tpu_torch.ops import stream_trace as st
from kajo_tpu_torch.scene.procedural import random_spheres_scene
from kajo_tpu_torch.scene.types import make_scene
from kajo_tpu_torch.utils import math3d
from stream_far_rays import far_rays

CASE_DESIGNS = {"rigid": ("v1", "v1-frustum", "v1-near-far", "v2", "v3"), "jitter": ("v1", "v2", "v3")}
# the kernel-building function of kajo_tpu each design must reach
KERNEL_FN = {"v1": "_build_kernel", "v1-frustum": "_build_kernel", "v1-near-far": "_build_kernel",
           "v2": "_build_kernel_v2", "v3": "_build_kernel_v3"}
KAJO_V1_TILE = 4096  # kajo_tpu's RAY_ROWS x 128


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return jax_script_reference(tmp_path_factory.mktemp("jax_stream_designs"), "_jax_stream_designs_ref.py",
                                CASE_DESIGNS, "_jax_stream_ref.py", "stream_far_rays.py")


def _inputs(case, ref):
    """kajo_tpu's packing as a prepared scene, and the rays -> (prep, o, d,
    t_max)."""
    prep = types.SimpleNamespace(
        rigid=case == "rigid", stream_packed=torch.tensor(ref["packed"]), stream_boxes=torch.tensor(ref["boxes"]),
        stream_perm=torch.tensor(ref["perm"]).long(),
    )
    return prep, torch.tensor(ref["o"]), torch.tensor(ref["d"]), torch.tensor(ref["t_max"])


def _bits_equal(got, want_t, want_idx):
    t, idx = got
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(t.numpy().view(np.int32), want_t.view(np.int32))


@pytest.mark.parametrize("case,design", [(c, d) for c, ds in CASE_DESIGNS.items() for d in ds])
def test_design_plain_matches_kajo(case, design, reference):
    ref = reference[case]
    assert ref[f"reached/{design}"].tolist() in ([KERNEL_FN[design]], [KERNEL_FN[design], "_frustum_candidates"])
    prep, o, d, t_max = _inputs(case, ref)
    launches = (st.nearest_launches, st.nearest_v1_launches, st.nearest_v2_launches, st.nearest_v3_launches)
    got = st.nearest_sphere(prep, o, d, t_max, design=design)
    assert launches == (st.nearest_launches, st.nearest_v1_launches, st.nearest_v2_launches, st.nearest_v3_launches)
    assert 200 < int((got[1] >= 0).sum()) < o.shape[0] - 200
    _bits_equal(got, ref[f"t/{design}"], ref[f"idx/{design}"])
    # rays in the field: K5's answer too
    _bits_equal(got, *(x.numpy() for x in st.nearest_sphere(prep, o, d, t_max, design="v4")))
    if design.startswith("v1"):  # at kajo_tpu's own tile
        bound = torch.clamp_max(t_max, st.BIG)
        order = {"v1": None, "v1-frustum": st.frustum_candidates(o, d, bound, prep.stream_boxes, KAJO_V1_TILE),
                 "v1-near-far": st.near_far_order(o, d, prep.stream_boxes, KAJO_V1_TILE)}[design]
        t, idx = st.nearest_v1_plain(prep.rigid, o, d, bound, prep.stream_packed, prep.stream_boxes, order,
                                     tile=KAJO_V1_TILE)
        found = idx >= 0
        idx = torch.where(found, prep.stream_perm[idx.clamp_min(0).long()], -1)
        _bits_equal((torch.where(found, t, float("inf")), idx), ref[f"t/{design}"], ref[f"idx/{design}"])


@pytest.mark.parametrize("design", ["v2", "v3"])
@pytest.mark.parametrize("case", list(CASE_DESIGNS))
def test_far_tile_vote_matches_kajo(case, design, reference):
    ref = reference[case]
    prep, *_ = _inputs(case, ref)
    o, d, t_max = (torch.tensor(ref[f"far_{k}"]) for k in ("o", "d", "t_max"))
    assert o.shape[0] == st.V2_TILE == st.V3_TILE and o.norm(dim=1).min() > 9e4
    got = st.nearest_sphere(prep, o, d, t_max, design=design)
    _bits_equal(got, ref[f"far_t/{design}"], ref[f"far_idx/{design}"])
    k5 = st.nearest_sphere(prep, o, d, t_max, design="v4")
    assert (got[1] >= 0).any() and (got[1] != k5[1]).any()


@pytest.mark.parametrize("tile", [KAJO_V1_TILE, st.V1_TILE])
@pytest.mark.parametrize("case", list(CASE_DESIGNS))
def test_frustum_candidates_match_kajo(case, tile, reference):
    ref = reference[case]
    prep, o, d, t_max = _inputs(case, ref)
    lists, counts = st.frustum_candidates(o, d, torch.clamp_max(t_max, st.BIG), prep.stream_boxes, tile)
    want = ref[f"frustum/{tile}"]
    n_tiles = -(-o.shape[0] // tile)
    assert lists.dtype == counts.dtype == torch.int32 and lists.shape == (n_tiles, prep.stream_boxes.shape[0])
    assert counts.min() > 0
    if n_tiles > 1:
        assert counts.min() < counts.max()  # the cull culls somewhere
    for j in range(n_tiles):
        c = int(counts[j])
        np.testing.assert_array_equal(lists[j, :c].numpy(), want[j, :c])
        assert (want[j, c:] == int(lists[j, c - 1])).all()  # kajo_tpu repeats the last candidate
        # the port's rows hold every block once: the unreachable ones after the count
        assert sorted(lists[j].tolist()) == list(range(lists.shape[1]))


def _det_scaled_scene():
    """test_bigscene.py's adversarial scene: a near det-1 cluster of 128
    spheres at x = 10 and a far cluster at x = 30 scaled by 0.2 (det 0.008,
    world radius 0.5), each one block; rays along +x through both."""
    rng = np.random.default_rng(2)
    jit_yz = rng.uniform(-2.0, 2.0, (128, 2)).astype(np.float32)
    grey = {"diffuse": np.array([0.5, 0.5, 0.5, 1], np.float32)}
    ident = math3d.identity()
    near = [{"transform": math3d.translate(ident, [10.0, float(y), float(z)]), "radius": 0.5, "material": grey}
            for y, z in jit_yz]
    scale = np.diag([0.2, 0.2, 0.2, 1.0]).astype(np.float32)
    far = [{"transform": math3d.translate(ident, [30.0, float(y), float(z)]) @ scale, "radius": 2.5, "material": grey}
           for y, z in jit_yz]
    camera = types.SimpleNamespace(transform=math3d.look_at([0, 0, -20], [10, 0, 0], [0, -1, 0]),
                                   projection=math3d.perspective(55.0, 4.0 / 3.0, 0.1, 100.0))
    scene = make_scene(camera, np.array([0, 0, 0, 1], np.float32), [], near + far, device="cpu")
    o = torch.tensor(np.concatenate([np.zeros((16, 1), np.float32), jit_yz[:16]], axis=1))
    return scene, o, torch.tensor([[1.0, 0.0, 0.0]]).expand(16, 3)


@pytest.mark.parametrize("design", st.DESIGNS)
def test_det_scaled_cull_adversarial(design, monkeypatch):
    """The far cluster's det-scaled t (~0.24) beats the near hit (9.5) though
    its block's world t_enter (~29.5) is beyond it: a cull without box slot
    6 (the min det) would keep the near winner."""
    scene, o, d = _det_scaled_scene()
    dense = geometry.trace(geometry.prepare_scene(scene), o, d)
    assert ((dense.obj >= 128) & (dense.obj < 256)).all(), "the far cluster must win"
    monkeypatch.setattr(geometry, "STREAM_THRESHOLD", 64)
    prep = geometry.prepare_scene(scene)
    assert not prep.rigid and prep.stream_packed is not None and prep.stream_boxes.shape[0] == 2
    assert abs(prep.sphere_det.min().item() - 0.008) < 1e-4
    with st.nearest_design(design):
        streamed = geometry.trace(prep, o, d)
    np.testing.assert_array_equal(streamed.obj.numpy(), dense.obj.numpy())


def _small_streamed(jitter=0.0):
    return geometry.prepare_scene(random_spheres_scene(1100, seed=1, extent=10.0, scale_jitter=jitter, device="cpu"))


def test_design_dispatch(monkeypatch):
    """The module setting, its context manager and ``design=`` pick the
    plain version; the context manager restores the setting, also on an
    error; an unknown name raises."""
    prep = _small_streamed()
    o = torch.zeros((4, 3))
    d = torch.tensor([[1.0, 0.0, 0.0]]).expand(4, 3)
    ran = []
    for name in ("nearest_sphere_plain", "nearest_v1_plain", "nearest_v2_plain", "nearest_v3_plain"):
        fn = getattr(st, name)
        monkeypatch.setattr(st, name, lambda *a, _fn=fn, _n=name, **k: (ran.append(_n), _fn(*a, **k))[1])
    st.nearest_sphere(prep, o, d)
    with st.nearest_design("v2"):
        assert st.NEAREST_DESIGN == "v2"
        st.nearest_sphere(prep, o, d)
        st.nearest_sphere(prep, o, d, design="v3")
        with pytest.raises(ZeroDivisionError), st.nearest_design("v1-frustum"):
            st.nearest_sphere(prep, o, d)
            1 / 0
        assert st.NEAREST_DESIGN == "v2"
    assert st.NEAREST_DESIGN == "v4"
    assert ran == ["nearest_sphere_plain", "nearest_v2_plain", "nearest_v3_plain", "nearest_v1_plain"]
    with pytest.raises(ValueError, match="unknown nearest-hit design"):
        st.nearest_sphere(prep, o, d, design="v5")
    with pytest.raises(ValueError, match="unknown nearest-hit design"), st.nearest_design("V1"):
        pass
    assert st.NEAREST_DESIGN == "v4"


def test_v3_over_the_residency_cap_runs_v1(monkeypatch):
    """kajo_tpu's rule: V3 only while the packed scene is at most
    V3_RESIDENT_BYTES, else V1 in packed order."""
    prep = _small_streamed(0.6)
    o, d = geometry.generate_rays(prep.camera, torch.linspace(0.1, 0.9, 8), torch.full((8,), 0.3))
    want = st.nearest_sphere(prep, o, d)
    calls = []
    for name in ("nearest_v1_plain", "nearest_v3_plain"):
        fn = getattr(st, name)
        monkeypatch.setattr(st, name, lambda *a, _fn=fn, _n=name, **k: (calls.append((_n, a[6:])), _fn(*a, **k))[1])
    size = prep.stream_packed.numel() * 4
    monkeypatch.setattr(st, "V3_RESIDENT_BYTES", size - 4)
    got = st.nearest_sphere(prep, o, d, design="v3")
    assert calls == [("nearest_v1_plain", (None,))]  # V1, packed order
    assert torch.equal(got[1], want[1]) and (got[1] >= 0).sum() == 6
    monkeypatch.setattr(st, "V3_RESIDENT_BYTES", size)
    st.nearest_sphere(prep, o, d, design="v3")
    assert calls[1:] == [("nearest_v3_plain", ())]  # at the cap, V3


@pytest.fixture(scope="module")
def k5_passes():
    """The K5 (design v4) pass of each streamed test scene, computed once."""
    return {}


PASS_W, PASS_H, PASS_SPP = 32, 24, 4
PASS_CFG = RenderConfig(max_depth=2, one_light_nee=True)


@pytest.mark.parametrize("jitter", [0.0, 0.5], ids=["rigid", "jitter"])
@pytest.mark.parametrize("design", st.DESIGNS[1:])
def test_streamed_pass_under_design(design, jitter, k5_passes, monkeypatch):
    """A CPU wavefront pass of a small streamed scene (``STREAM_THRESHOLD``
    lowered to 64: 400 spheres, 4 blocks) under each design, against the
    same pass with K5: tone-mapped MAD <= 5e-4, mean relative gap <= 1%.
    The rigid scene's shadow rays stay on K6; the jittered scene's go
    through the design too."""
    monkeypatch.setattr(geometry, "STREAM_THRESHOLD", 64)
    scene = random_spheres_scene(400, seed=21, extent=15.0, n_lights=3, scale_jitter=jitter, device="cpu")
    assert geometry.prepare_scene(scene).stream_packed is not None
    if jitter not in k5_passes:
        k5_passes[jitter] = wavefront.render_pass_fast(scene, 7, PASS_W, PASS_H, PASS_SPP, PASS_CFG).numpy()
    want = k5_passes[jitter]
    calls = []
    plain = {d: getattr(st, f"nearest_{d[:2]}_plain") for d in ("v1", "v2", "v3")}
    for k, fn in plain.items():
        monkeypatch.setattr(st, f"nearest_{k}_plain",
                            lambda *a, _fn=fn, _k=k, **kw: (calls.append(_k), _fn(*a, **kw))[1])
    with st.nearest_design(design):
        got = wavefront.render_pass_fast(scene, 7, PASS_W, PASS_H, PASS_SPP, PASS_CFG).numpy()
    assert calls and set(calls) == {design[:2]}
    assert np.isfinite(got).all() and got[..., :3].mean() > 0
    mad, rel = tm_mad(got, want), mean_rel(got, want)
    print(f"{design} jitter={jitter}: tone-mapped MAD {mad:.3e}, mean relative gap {rel:.3e} against K5")  # pytest -rP
    assert mad <= 5e-4, mad
    assert rel <= 0.01, rel


def test_counting_scans_counts_v3_marks():
    """``counting_scans`` counts what K9's function scans: per tile, its
    marked blocks (``frustum_reach``) times its rays in the call, and the
    (ray, sphere) pairs of those blocks with a discriminant >= 0; nothing
    when off, and the setting is restored."""
    prep = _small_streamed()
    rng = np.random.default_rng(6)
    n = 2 * st.V3_TILE + 100
    o = torch.tensor(rng.uniform(-10, 10, (n, 3)).astype(np.float32))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = torch.tensor(d / np.linalg.norm(d, axis=1, keepdims=True))
    bound = torch.tensor(rng.uniform(0.5, 4.0, n).astype(np.float32))
    marks = st.frustum_reach(*st._tile_bounds(o, d, bound, st.V3_TILE)[:5], prep.stream_boxes)
    rays = torch.tensor([st.V3_TILE, st.V3_TILE, 100])
    with st.counting_scans() as counts:
        want = st.nearest_v3_plain(True, o, d, bound, prep.stream_packed, prep.stream_boxes)
    assert counts["pairs"] == int((marks.sum(1) * rays).sum()) > 0
    assert counts["blocks"] == set(torch.nonzero(marks.any(0)).squeeze(1).tolist())
    packed = prep.stream_packed
    discr = st.rigid_terms(*packed.T[:3], st.rigid_const(*packed.T), *st.ray_terms(o, d))[2]
    scanned = marks[torch.arange(n) // st.V3_TILE][:, torch.arange(packed.shape[0]) // st.BLOCK]
    assert int(counts["roots"]) == int((scanned & (discr >= 0)).sum()) > 0
    assert st._scan_counts is None
    got = st.nearest_v3_plain(True, o, d, bound, prep.stream_packed, prep.stream_boxes)
    assert torch.equal(got[1], want[1]) and counts["pairs"] == int((marks.sum(1) * rays).sum())


def test_lists_on_a_partial_tile():
    """A call whose last tile is partial: the lists cover ceil(N / tile)
    tiles, padding lanes count as dead, and every design's plain version
    gives K5's answer on rays in the field."""
    prep = _small_streamed()
    rng = np.random.default_rng(5)
    n = 3 * st.V1_TILE + 17
    o = torch.tensor(rng.uniform(-10, 10, (n, 3)).astype(np.float32))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = torch.tensor(d / np.linalg.norm(d, axis=1, keepdims=True))
    bound = torch.full((n,), st.BIG)
    lists, counts = st.near_far_order(o, d, prep.stream_boxes)
    assert lists.shape == (4, prep.stream_boxes.shape[0]) and counts.shape == (4,)
    sboxes, cand, ccount = st.v2_candidates(o, d, bound, prep.stream_boxes)
    assert sboxes.shape == (2, 8) and cand.shape == (1, 2) and ccount.tolist() == [2]
    want = st.nearest_sphere(prep, o, d)
    for design in st.DESIGNS[1:]:
        got = st.nearest_sphere(prep, o, d, design=design)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))


@pytest.mark.parametrize("jitter", [0.0, 0.6], ids=["rigid", "general"])
def test_v1_votes_refused_at_the_start_stay_refused(jitter):
    """The vote box_may_hit is t_exit >= t_enter and t_enter * min det <
    t_best, and t_best only falls, so a block that no ray of a tile admits
    at the rays' starting bounds is refused at every later t_best too (a
    NaN compares false both times). On the 1500-sphere field, in-field rays
    and the far rays of ``stream_far_rays`` (whose answers the vote
    decides): each tile's list, in all three orders, cut to the blocks its
    vote admits at the starting bounds gives the bits of the whole list."""
    prep = geometry.prepare_scene(random_spheres_scene(1500, seed=4, extent=20.0, scale_jitter=jitter, device="cpu"))
    # in-field tiles: origins within 1 of a point of the field, in all directions, bounds 1-6 (half unbounded
    # in the first tile), so that a tile's vote refuses some blocks at the start and admits some only then
    rng = np.random.default_rng(8)
    n_in = 3 * st.V1_TILE
    centre = np.repeat(rng.uniform(-16, 16, (3, 3)), st.V1_TILE, axis=0)
    centre[:, 1] = 0.0
    o_in = (centre + rng.uniform(-1, 1, (n_in, 3))).astype(np.float32)
    d_in = rng.normal(size=(n_in, 3)).astype(np.float32)
    d_in /= np.linalg.norm(d_in, axis=1, keepdims=True)
    b_in = rng.uniform(1, 6, n_in).astype(np.float32)
    b_in[: st.V1_TILE : 2] = np.inf
    far = far_rays()
    o = torch.tensor(np.concatenate([o_in, far[0]]))
    d = torch.tensor(np.concatenate([d_in, far[1]]))
    bound = torch.clamp_max(torch.tensor(np.concatenate([b_in, far[2]])), st.BIG)
    boxes, n_blocks = prep.stream_boxes, prep.stream_boxes.shape[0]
    n_tiles = -(-o.shape[0] // st.V1_TILE)
    t_enter, entered = st._slab(o, d, boxes)
    admit = st._by_tile(entered & (t_enter * boxes[:, 6] < bound[:, None]), st.V1_TILE, False).any(1)  # [T, B]
    args = (prep.rigid, o, d, bound, prep.stream_packed, boxes)
    for design in ("v1", "v1-frustum", "v1-near-far"):
        (order,) = st.design_lists(design, o, d, bound, boxes)
        lists, counts = order if order is not None else (
            torch.arange(n_blocks, dtype=torch.int32).expand(n_tiles, n_blocks), torch.full((n_tiles,), n_blocks))
        keep = admit.gather(1, lists.long()) & (torch.arange(n_blocks) < counts[:, None])
        first = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)  # the kept entries first, in list order
        cut = (lists.gather(1, first).to(torch.int32).contiguous(), keep.sum(1).to(torch.int32))
        assert (cut[1] < counts).any() and (cut[1] > 0).all()
        t_w, i_w = st.nearest_v1_plain(*args, order)
        t_c, i_c = st.nearest_v1_plain(*args, cut)
        assert int((i_w >= 0).sum()) > 100
        assert torch.equal(i_c, i_w) and torch.equal(t_c.view(torch.int32), t_w.view(torch.int32)), design
