"""The CUDA kernels against their plain PyTorch versions on the card: the
megakernel (K1, in both of its regimes), the streaming trace (K5 nearest hit, K6 occlusion, and the
nearest-hit designs K7, K8, K9) and the gradient kernels (K2 forward mode, K3 material and K4 geometry gradients);
and the parity engine, the boundary terms and the budget engine (engine jax), which have no kernel of their own,
on the card against the CPU.

Needs a CUDA device, nvcc and no jax, so on a GPU machine run it without the
JAX test configuration:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Elsewhere every test skips."""

import os

import numpy as np
import pytest
import torch

from kajo_tpu_torch.models import wavefront
from kajo_tpu_torch.models.integrator import RenderConfig
from kajo_tpu_torch.ops import geometry, megakernel, stream_trace
from kajo_tpu_torch.scene import parser
from kajo_tpu_torch.scene.procedural import random_spheres_scene
from kajo_tpu_torch.scene.testscene import build_two_light_scene
from stream_far_rays import far_rays

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


def _stream_rays(prep, n_side=64, seed=0):
    """n_side² primary rays and as many scattered ones, made with numpy."""
    xs, ys = np.meshgrid(np.linspace(0.01, 0.99, n_side), np.linspace(0.01, 0.99, n_side))
    dev = prep.sphere_center.device
    o_p, d_p = geometry.generate_rays(
        prep.camera, torch.tensor(xs.ravel(), dtype=torch.float32, device=dev),
        torch.tensor(ys.ravel(), dtype=torch.float32, device=dev),
    )
    rng = np.random.default_rng(seed)
    m = n_side * n_side
    o_s = rng.uniform(-30, 30, (m, 3)).astype(np.float32)
    o_s[:, 1] = rng.uniform(-2, 0.99, m)
    d_s = rng.normal(size=(m, 3)).astype(np.float32)
    d_s /= np.linalg.norm(d_s, axis=1, keepdims=True)
    o = torch.cat([o_p, torch.tensor(o_s, device=dev)]).contiguous()
    d = torch.cat([d_p, torch.tensor(d_s, device=dev)]).contiguous()
    bound = torch.tensor(rng.uniform(1, 80, 2 * m).astype(np.float32), device=dev)
    bound[::3] = stream_trace.BIG
    return o, d, bound


@pytest.mark.parametrize("jitter", [0.0, 0.5], ids=["rigid", "general"])
def test_stream_kernels_match_plain(device, jitter):
    """Same winners on every ray and t equal to the bit (K5); the same
    occlusion on every ray, the light's row excluded on half of them (K6)."""
    prep = geometry.prepare_scene(random_spheres_scene(20000, seed=3, extent=30.0, scale_jitter=jitter, device=device))
    o, d, bound = _stream_rays(prep)
    args = (prep.rigid, o, d, bound, prep.stream_packed, prep.stream_boxes)
    before = (stream_trace.nearest_launches, stream_trace.occluded_launches)
    t_k, i_k = stream_trace.launch_nearest(*args)
    t_p, i_p = stream_trace.nearest_sphere_plain(*args)
    torch.cuda.synchronize()
    assert int((i_p >= 0).sum()) > 1000
    assert torch.equal(i_k, i_p)
    assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
    excl = torch.where(torch.arange(o.shape[0], device=device) % 2 == 0, i_p, -1).to(torch.int32)
    cut = torch.where(i_p >= 0, t_p * 1.5, bound)
    args = (prep.rigid, o, d, cut, excl, prep.stream_packed, prep.stream_boxes)
    occ_k = stream_trace.launch_occluded(*args)
    occ_p = stream_trace.occluded_sphere_plain(*args)
    torch.cuda.synchronize()
    assert 0 < int((occ_p == 0).sum()) < o.shape[0]
    assert torch.equal(occ_k.view(torch.int32), occ_p.view(torch.int32))
    assert (stream_trace.nearest_launches, stream_trace.occluded_launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("jitter", [0.0, 0.5], ids=["rigid", "general"])
def test_nearest_kernel_in_any_ray_order(device, jitter):
    """K5 on the rays as given, reversed and in a random order (other rays
    share each ray's warp) equals its plain version on every ray, bit for
    bit, with the scene's superblocks and with those its wrapper builds."""
    prep = geometry.prepare_scene(random_spheres_scene(20000, seed=3, extent=30.0, scale_jitter=jitter, device=device))
    o, d, bound = _stream_rays(prep)
    n = o.shape[0]
    orders = {"as given": torch.arange(n, device=device),
              "reversed": torch.arange(n - 1, -1, -1, device=device),
              "random": torch.tensor(np.random.default_rng(7).permutation(n), device=device)}
    for label, order in orders.items():
        for sboxes in (prep.stream_sboxes, None):
            args = (prep.rigid, o[order].contiguous(), d[order].contiguous(), bound[order].contiguous(),
                    prep.stream_packed, prep.stream_boxes, sboxes)
            t_k, i_k = stream_trace.launch_nearest(*args)
            t_p, i_p = stream_trace.nearest_sphere_plain(*args)
            torch.cuda.synchronize()
            assert int((i_p >= 0).sum()) > 1000, label
            assert torch.equal(i_k, i_p), label
            assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32)), label


@pytest.mark.parametrize("case", ["all-occluded", "none-occluded", "only-the-excluded-row"])
def test_occlusion_kernel_on_whole_warps(device, case):
    """K6 on a rigid field where every ray of every warp is occluded, where
    none is, and where only each ray's excluded row lies below its cut:
    equal to its plain version on every ray, bit for bit, with the scene's
    superblocks and with those its wrapper builds."""
    prep = geometry.prepare_scene(random_spheres_scene(20000, seed=3, extent=30.0, device=device))
    o, d, bound = _stream_rays(prep)
    t, idx = stream_trace.launch_nearest(prep.rigid, o, d, bound, prep.stream_packed, prep.stream_boxes)
    hit = torch.nonzero(idx >= 0).squeeze(1)
    o, d, t, idx = o[hit].contiguous(), d[hit].contiguous(), t[hit], idx[hit]
    none = torch.full_like(idx, -1)
    cut, excl, want = {
        "all-occluded": (t * 1.5, none, 0),
        "none-occluded": (t * 0.5, none, o.shape[0]),
        # the nearest sphere is the only one below a cut just past it, and it is excluded
        "only-the-excluded-row": (torch.nextafter(t, torch.full_like(t, float("inf"))), idx, None),
    }[case]
    for sboxes in (prep.stream_sboxes, None):
        args = (prep.rigid, o, d, cut.contiguous(), excl.to(torch.int32).contiguous(), prep.stream_packed,
                prep.stream_boxes, sboxes)
        occ_k = stream_trace.launch_occluded(*args)
        occ_p = stream_trace.occluded_sphere_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(occ_k.view(torch.int32), occ_p.view(torch.int32))
        unoccluded = int((occ_p != 0).sum())
        if want is not None:
            assert unoccluded == want
        else:
            assert unoccluded > 0.95 * o.shape[0]
    if case == "only-the-excluded-row":  # the same cuts without the exclusion: (nearly) all occluded
        args = (prep.rigid, o, d, cut.contiguous(), none.to(torch.int32), prep.stream_packed, prep.stream_boxes)
        assert int((stream_trace.launch_occluded(*args) != 0).sum()) < 0.01 * o.shape[0]


@pytest.mark.parametrize(
    "name,w,h,spp,config",
    [
        ("caustics.json", 16, 12, 144, RenderConfig(max_depth=3)),  # a thread a sample, two waves of 72
        ("caustics.json", 8, 6, 81, RenderConfig(max_depth=100)),  # a 64-thread log, two waves of 41
        ("scaled.json", 32, 24, 16, RenderConfig(max_depth=4)),  # the general record
        ("two-light", 32, 24, 16, RenderConfig(max_depth=4, one_light_nee=True)),
        ("caustics.json", 32, 24, 16, RenderConfig(max_depth=20, full_mis=True, regen_threshold=0.01)),
        ("caustics.json", 320, 272, 4, RenderConfig()),  # 87,040 lanes: a thread a lane
        ("scaled.json", 320, 272, 4, RenderConfig()),
        ("random150", 32, 24, 4, RenderConfig()),  # 5,767 floats: the scene read from global memory
        ("caustics.json", 2, 1, 16, RenderConfig(max_depth=9683)),  # a one-thread log fills the CTA: unstaged
    ],
    ids=["two-waves", "depth100-two-waves", "scaled", "one-light", "full-mis-regen-depth20", "lanes-caustics",
         "lanes-scaled", "unstaged-general", "deepest-log-unstaged"],
)
def test_megakernel_regimes_equal_plain_bits(device, name, w, h, spp, config):
    """K1 in both of its regimes (a thread a (lane, sample) below
    K1_RESIDENT_THREADS lanes, a thread a lane above), with the scene in
    shared memory and, above 16 KB, in global memory, equals its plain
    version's sums bit for bit."""
    if name == "two-light":
        scene = build_two_light_scene(w / h, device)
    elif name == "random150":
        scene = random_spheres_scene(150, seed=6, extent=8.0, scale_jitter=0.5, aspect_ratio=w / h, device=device)
    else:
        scene = parser.load(os.path.join(DATA, name), w / h, device)
    ps = megakernel.prepare_pass(scene, w, h, spp, config)
    plan = megakernel.k1_plan(ps.n_lanes, ps.eff, config.max_depth)
    assert (plan is None) == (ps.n_lanes >= megakernel.K1_RESIDENT_THREADS)
    if spp > 64:
        assert plan.waves == 2
    got = megakernel.launch_kernel(ps, 21)
    want = megakernel.trace_lanes_plain(ps, 21)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and got.abs().sum() > 0
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("source", ["megakernel.cu", "megakernel_jvp.cu"])
def test_plans_mirror_the_kernels_constants(device, source):
    """The Python plans (megakernel.k1_plan, jvp_plan) use the thresholds
    and shared-byte rules K1 and K2 were compiled with."""
    resident, floats = {
        "megakernel.cu": (megakernel.K1_RESIDENT_THREADS, megakernel.K1_FLOATS),
        "megakernel_jvp.cu": (megakernel.JVP_RESIDENT_THREADS, megakernel.JVP_FLOATS),
    }[source]
    want = (megakernel.PLAN_MAX_THREADS, megakernel.PLAN_SHARED_LIMIT, resident, *floats)
    assert megakernel.built_plan_constants(source) == want


def _hold_design(design, prep, o, d, bound):
    """One launch of the design's kernel against its plain version on these
    rays: the same winner on every ray and t equal to the bit, one launch
    counted -> (t, idx) of the kernel."""
    boxes = prep.stream_boxes
    kind = design[:2]
    lists = {"v1": (None,), "v1-frustum": (stream_trace.frustum_candidates(o, d, bound, boxes),),
             "v1-near-far": (stream_trace.near_far_order(o, d, boxes),),
             "v2": (stream_trace.v2_candidates(o, d, bound, boxes),), "v3": ()}[design]
    args = (prep.rigid, o, d, bound, prep.stream_packed, boxes, *lists)
    counter = f"nearest_{kind}_launches"
    before = getattr(stream_trace, counter)
    t_k, i_k = getattr(stream_trace, f"launch_nearest_{kind}")(*args)
    t_p, i_p = getattr(stream_trace, f"nearest_{kind}_plain")(*args)
    torch.cuda.synchronize()
    assert getattr(stream_trace, counter) == before + 1
    assert torch.equal(i_k, i_p)
    assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
    return t_k, i_k


@pytest.mark.parametrize("jitter", [0.0, 0.6], ids=["rigid", "general"])
@pytest.mark.parametrize("design", ["v1", "v1-frustum", "v1-near-far", "v2", "v3"])
def test_design_kernels_match_plain(device, design, jitter):
    """K7 (three block orders), K8 and K9 against their plain versions on
    the 1500-sphere scene of the CPU tests: the same winner on every ray and
    t equal to the bit, one launch each, and K5's winners on these rays.
    Then, in tiles of the design's own size (V1_TILE for K7, 512 rays for
    K8 and K9), on a call of in-field rays, the far rays of the CPU tests
    (whose tile votes give some ray a winner unlike K5's), a tile of rays
    with d = 0 (no live ray: nothing found) and a partial last tile, and on
    a call of fewer rays than one tile."""
    prep = geometry.prepare_scene(random_spheres_scene(1500, seed=4, extent=20.0, scale_jitter=jitter, device=device))
    assert prep.stream_packed is not None
    o, d, bound = _stream_rays(prep, n_side=48)
    _, i_k = _hold_design(design, prep, o, d, bound)
    t_5, i_5 = stream_trace.launch_nearest(prep.rigid, o, d, bound, prep.stream_packed, prep.stream_boxes)
    assert int((i_k >= 0).sum()) > 500
    assert torch.equal(i_k, i_5)
    far = [torch.tensor(x, device=device) for x in far_rays()]
    far[2] = torch.clamp_max(far[2], stream_trace.BIG)
    tile = {"v1": stream_trace.V1_TILE, "v2": stream_trace.V2_TILE, "v3": stream_trace.V3_TILE}[design[:2]]
    n_far = far[0].shape[0]
    assert n_far % tile == 0
    # in-field rays | the far rays | a tile with d = 0 | 300 in-field rays, the last tile partial
    cut = [slice(0, 2 * tile), slice(None), slice(0, tile), slice(2 * tile, 2 * tile + 300)]
    mixed = [torch.cat([x[cut[0]], f, x[cut[2]], x[cut[3]]]).contiguous() for x, f in zip((o, d, bound), far)]
    zero = slice(2 * tile + n_far, 3 * tile + n_far)
    mixed[1][zero] = 0.0
    t_k, i_k = _hold_design(design, prep, *mixed)
    t_5, i_5 = stream_trace.launch_nearest(prep.rigid, *mixed, prep.stream_packed, prep.stream_boxes)
    far_rows = slice(2 * tile, 2 * tile + n_far)
    assert (i_k[far_rows] != i_5[far_rows]).any()
    assert (i_k[zero] == -1).all()
    assert torch.equal(t_k[zero], mixed[2][zero])
    assert torch.equal(i_k[zero.stop :], i_5[zero.stop :]) and torch.equal(i_k[: 2 * tile], i_5[: 2 * tile])
    short = 300 if tile > 300 else tile - 28
    _hold_design(design, prep, *(x[2 * tile : 2 * tile + short].contiguous() for x in mixed))


@pytest.mark.parametrize("jitter", [0.0, 0.6], ids=["rigid", "general"])
def test_v1_kernel_when_every_block_is_admitted(device, jitter):
    """K7 against its plain version where every tile's vote admits every
    block (each ray starts at the centre of a block's box, so it enters
    the box at t = 0, below any positive bound; 38 blocks, 3 tiles and a
    partial one) in packed order, and on lists in a shuffled order whose
    lengths (37, 33, 5, 37) are no multiple of a lane or chunk count."""
    prep = geometry.prepare_scene(random_spheres_scene(4741, seed=4, extent=20.0, scale_jitter=jitter, device=device))
    boxes = prep.stream_boxes
    n_blocks, n = boxes.shape[0], 3 * stream_trace.V1_TILE + 50
    assert n_blocks == 38 and prep.rigid == (jitter == 0.0)
    centre = 0.5 * (boxes[:, 0:3] + boxes[:, 3:6])
    o = centre[torch.arange(n, device=device) % n_blocks].contiguous()
    rng = np.random.default_rng(3)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = torch.tensor(d / np.linalg.norm(d, axis=1, keepdims=True), device=device)
    bound = torch.full((n,), stream_trace.BIG, device=device)
    args = (prep.rigid, o, d, bound, prep.stream_packed, boxes)
    with stream_trace.counting_scans() as scans:
        stream_trace.nearest_v1_plain(*args)
    assert scans["tiles"].tolist() == [n_blocks] * 4
    _, i_k = _hold_design("v1", prep, o, d, bound)
    assert int((i_k >= 0).sum()) > n // 2
    lists = torch.stack([torch.tensor(rng.permutation(n_blocks), dtype=torch.int32) for _ in range(4)]).to(device)
    counts = torch.tensor([37, 33, 5, 37], dtype=torch.int32, device=device)
    t_k, i_k = stream_trace.launch_nearest_v1(*args, (lists, counts))
    t_p, i_p = stream_trace.nearest_v1_plain(*args, (lists, counts))
    torch.cuda.synchronize()
    assert torch.equal(i_k, i_p) and torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))


def test_streamed_pass_launches_the_stream_kernels(device, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA trace reached a plain version")

    monkeypatch.setattr(stream_trace, "nearest_sphere_plain", refuse)
    monkeypatch.setattr(stream_trace, "occluded_sphere_plain", refuse)
    scene = random_spheres_scene(3000, seed=2, extent=20.0, n_lights=3, device=device)
    before = (stream_trace.nearest_launches, stream_trace.occluded_launches)
    img = wavefront.render_pass_fast(scene, 9, 64, 48, 4, RenderConfig(max_depth=2, one_light_nee=True))
    torch.cuda.synchronize()
    assert torch.isfinite(img).all() and img[..., :3].mean() > 0
    assert stream_trace.nearest_launches > before[0] and stream_trace.occluded_launches > before[1]


# ---- the gradient kernels: K2 (forward mode), K3 (materials), K4 (geometry)
W, H, SPP = 32, 24, 4


def _grad_scene(name, device):
    from kajo_tpu_torch.scene.testscene import build_mirror_cluster

    if name == "two-light":
        return build_two_light_scene(W / H, device)
    if name == "mirror-cluster":
        return build_mirror_cluster(W / H, device)
    if name == "random40":
        return random_spheres_scene(40, seed=11, extent=10.0, n_lights=2, aspect_ratio=W / H, device=device)
    return parser.load(os.path.join(DATA, name), W / H, device)


GRAD_CASES = [
    ("caustics.json", RenderConfig(max_depth=3)),
    ("scaled.json", RenderConfig(max_depth=3)),
    ("two-light", RenderConfig(max_depth=3, one_light_nee=True)),
    ("caustics.json", RenderConfig(max_depth=3, full_mis=True)),
    ("random40", RenderConfig(max_depth=3)),
    ("mirror-cluster", RenderConfig(max_depth=20)),
]
GRAD_IDS = ["caustics", "scaled", "one-light", "full-mis", "random40", "mirror-cluster-depth20"]


def _within(got, want):
    """Every field: max|kernel - plain| <= 1e-4 max|plain| + 1e-7, finite."""
    for k in want:
        assert torch.isfinite(got[k]).all(), k
        assert (got[k] - want[k]).abs().max().item() <= 1e-4 * want[k].abs().max().item() + 1e-7, k


@pytest.mark.parametrize("name,config", GRAD_CASES, ids=GRAD_IDS)
def test_jvp_kernel_matches_plain(device, name, config):
    """K2's image equals K1's bit for bit; its tangent is within a relative
    L2 gap of 1e-4 of forward-mode autodiff of the plain walk."""
    scene = _grad_scene(name, device)
    tan = megakernel.scene_zero_tangent(scene)
    tan.sphere_transform[0, 0, 3] = 1.0
    tan.sphere_radius[-1] = 1.0
    tan.materials.diffuse[0, 1] = 1.0
    ps, packed_dot = megakernel.prepare_pass_jvp(scene, tan, W, H, SPP, config)
    before = megakernel.jvp_launches
    sums, sums_dot = megakernel.launch_kernel_jvp(ps, packed_dot, 31)
    k1 = megakernel.launch_kernel(ps, 31)
    want, want_dot = megakernel.trace_lanes_plain_jvp(ps, packed_dot, 31)
    torch.cuda.synchronize()
    assert megakernel.jvp_launches == before + 1
    assert torch.equal(sums.view(torch.int32), k1.view(torch.int32))
    assert torch.isfinite(sums_dot).all()
    assert ((sums_dot - want_dot).norm() / want_dot.norm()).item() <= 1e-4


@pytest.mark.parametrize(
    "w,h,spp,config",
    [
        (16, 12, 144, RenderConfig(max_depth=3)),  # a lane's 144 samples in two waves of 72
        (8, 6, 81, RenderConfig(max_depth=100)),  # a CTA of 41 threads, 100 KB of log, two waves
        (W, H, SPP, RenderConfig(max_depth=20, full_mis=True)),  # two terms at every vertex
    ],
    ids=["two-waves", "depth100-two-waves", "caustics-depth20-full-mis"],
)
def test_jvp_kernel_in_waves_and_deep(device, w, h, spp, config):
    """K2 where a lane's samples need more than one wave of its log, or the
    log takes many terms: the image still equals K1's bit for bit."""
    scene = parser.load(os.path.join(DATA, "caustics.json"), w / h, device)
    tan = megakernel.scene_zero_tangent(scene)
    tan.sphere_transform[0, 0, 3] = 1.0
    tan.materials.diffuse[0, 1] = 1.0
    ps, packed_dot = megakernel.prepare_pass_jvp(scene, tan, w, h, spp, config)
    if spp > SPP:
        assert megakernel.jvp_plan(ps.n_lanes, ps.eff, config.max_depth).waves == 2
    sums, sums_dot = megakernel.launch_kernel_jvp(ps, packed_dot, 8)
    k1 = megakernel.launch_kernel(ps, 8)
    want, want_dot = megakernel.trace_lanes_plain_jvp(ps, packed_dot, 8)
    torch.cuda.synchronize()
    assert torch.equal(sums.view(torch.int32), k1.view(torch.int32))
    assert torch.isfinite(sums_dot).all()
    assert ((sums_dot - want_dot).norm() / want_dot.norm()).item() <= 1e-4


def test_auto_engine_on_the_card_is_mega(device):
    """The reference's rule: engine auto takes mega for a scene on the
    accelerator that the megakernel takes, and fast above it."""
    from kajo_tpu_torch.models.engine import select_engine

    assert select_engine(parser.load(os.path.join(DATA, "caustics.json"), 1.0, device)) == "mega"
    assert select_engine(random_spheres_scene(600, seed=1, extent=10.0, device=device)) == "fast"


@pytest.mark.parametrize("name,config", GRAD_CASES, ids=GRAD_IDS)
def test_grad_kernels_match_plain(device, name, config):
    from kajo_tpu_torch.ops import megakernel_geom, megakernel_grad

    scene = _grad_scene(name, device)
    g = torch.rand((H, W, 3), generator=torch.Generator().manual_seed(4)).to(device)
    before = (megakernel_grad.kernel_launches, megakernel_geom.kernel_launches)
    _within(megakernel_grad.material_grads(scene, 31, g, W, H, SPP, config),
            megakernel_grad.material_grads_plain(scene, 31, g, W, H, SPP, config))
    _within(megakernel_geom.geometry_grads(scene, 31, g, W, H, SPP, config),
            megakernel_geom.geometry_grads_plain(scene, 31, g, W, H, SPP, config))
    assert (megakernel_grad.kernel_launches, megakernel_geom.kernel_launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("name,config", GRAD_CASES, ids=GRAD_IDS)
def test_grad_kernels_repeat_bit_for_bit(device, name, config):
    """K3 and K4 sum their per-CTA tables exactly, whatever order their
    atomics take (csrc/exact_sum.cuh): two calls on the same inputs give
    the same bits."""
    from kajo_tpu_torch.ops import megakernel_geom, megakernel_grad

    scene = _grad_scene(name, device)
    g = torch.rand((H, W, 3), generator=torch.Generator().manual_seed(4)).to(device)
    for fn in (megakernel_grad.material_grads, megakernel_geom.geometry_grads):
        a, b = (fn(scene, 31, g, W, H, SPP, config) for _ in range(2))
        torch.cuda.synchronize()
        for k in a:
            assert torch.equal(a[k].view(torch.int32), b[k].view(torch.int32)), (fn.__name__, k)


def test_grad_kernels_with_tables_beyond_48kb(device):
    """503 objects: K3's table takes 200 KB of shared memory and K4's 88 KB,
    past the 48 KB a kernel gets without opting in. Both stay within the bar
    of the plain versions and repeat bit for bit."""
    from kajo_tpu_torch.ops import megakernel_geom, megakernel_grad

    scene = random_spheres_scene(500, seed=3, extent=10.0, n_lights=2, aspect_ratio=16 / 12, device=device)
    assert scene.num_objects == 503
    config = RenderConfig(max_depth=3)
    g = torch.rand((12, 16, 3), generator=torch.Generator().manual_seed(4)).to(device)
    for fn, plain in ((megakernel_grad.material_grads, megakernel_grad.material_grads_plain),
                      (megakernel_geom.geometry_grads, megakernel_geom.geometry_grads_plain)):
        a, b = (fn(scene, 31, g, 16, 12, 4, config) for _ in range(2))
        torch.cuda.synchronize()
        for k in a:
            assert torch.equal(a[k].view(torch.int32), b[k].view(torch.int32)), (fn.__name__, k)
        _within(a, plain(scene, 31, g, 16, 12, 4, config))


def test_inverse_loop_repeats_bit_for_bit(device):
    """Engine mega, every sphere's transform and every albedo, K1 forward
    and K3/K4 backward: two runs of a few Adam steps give the same losses
    and the same parameters, bit for bit."""
    from kajo_tpu_torch.diff.inverse import InverseRenderer, apply_params

    scene = parser.load(os.path.join(DATA, "caustics.json"), W / H, device)
    target = megakernel.render_pass_megakernel(scene, 1, W, H, 16)
    st = scene.sphere_transform.clone()
    st[0, 0, 3] += 0.2
    st[0, 2, 3] -= 0.1
    wrong = apply_params(scene, {"sphere_transform": st})
    runs = []
    for _ in range(2):
        inv = InverseRenderer(wrong, target, W, H, spp=SPP, loss_clip=1.0, learning_rate=2e-2,
                              param_spec=("sphere_transform", "diffuse"), engine="mega", seed=7)
        losses = [inv.step() for _ in range(6)]
        runs.append((losses, {k: v.detach().clone() for k, v in inv.params.items()}))
    assert runs[0][0] == runs[1][0]
    for k in runs[0][1]:
        assert torch.equal(runs[0][1][k].view(torch.int32), runs[1][1][k].view(torch.int32)), k


@pytest.mark.parametrize("name", ["caustics.json", "scaled.json"], ids=["caustics", "scaled"])
def test_geometry_kernel_matches_plain_64x48(device, name):
    """K4 at chip_smoke.py's 64x48, 4 spp, depth 3: a grid of 96 CTAs of
    (lane, sample) items, against autodiff of the plain walk."""
    from kajo_tpu_torch.ops import megakernel_geom

    scene = parser.load(os.path.join(DATA, name), 64 / 48, device)
    config = RenderConfig(max_depth=3)
    g = torch.rand((48, 64, 3), generator=torch.Generator().manual_seed(0)).to(device)
    before = megakernel_geom.kernel_launches
    got = megakernel_geom.geometry_grads(scene, 2024, g, 64, 48, 4, config)
    want = megakernel_geom.geometry_grads_plain(scene, 2024, g, 64, 48, 4, config)
    torch.cuda.synchronize()
    assert megakernel_geom.kernel_launches == before + 1
    _within(got, want)


def test_inverse_step_on_the_card(device, monkeypatch):
    """One step of each engine on a CUDA scene launches the kernels and never
    a plain version."""
    from kajo_tpu_torch.diff.inverse import InverseRenderer
    from kajo_tpu_torch.ops import megakernel_geom, megakernel_grad

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA scene reached a plain version")

    for mod, name in ((megakernel, "trace_lanes_plain"), (megakernel, "trace_lanes_plain_jvp"),
                      (megakernel_grad, "material_grads_plain"), (megakernel_geom, "geometry_grads_plain")):
        monkeypatch.setattr(mod, name, refuse)
    scene = parser.load(os.path.join(DATA, "caustics.json"), W / H, device)
    target = megakernel.render_pass_megakernel(scene, 1, W, H, 16)
    mask = torch.zeros(scene.sphere_transform.shape, dtype=torch.bool)
    mask[2, :3, 3] = True
    for kw in (dict(param_spec=("sphere_transform", "diffuse")),
               dict(engine="mega-fwd", param_spec=("sphere_transform",), param_mask={"sphere_transform": mask})):
        inv = InverseRenderer(scene, target, W, H, spp=SPP, loss_clip=1.0, **kw)
        loss = inv.step()
        assert torch.isfinite(torch.tensor(loss))


@pytest.mark.parametrize(
    "name,config",
    [("caustics.json", RenderConfig()), ("scaled.json", RenderConfig()),
     ("two-light", RenderConfig(one_light_nee=True))],
    ids=["caustics", "scaled", "one-light"],
)
def test_parity_pass_on_the_card_equals_the_cpu(device, name, config):
    """The parity engine (plain PyTorch, no kernel of its own) on the card
    against the same pass on the CPU: the counter key gives both the same
    stream. Bars of the megakernel against its plain version."""
    from kajo_tpu_torch.models.integrator import render_pass

    def load(dev):
        if name == "two-light":
            return build_two_light_scene(64 / 48, dev)
        return parser.load(os.path.join(DATA, name), 64 / 48, dev)

    before = megakernel.kernel_launches
    got = render_pass(load(device), 1234, 64, 48, 4, config)
    want = render_pass(load("cpu"), 1234, 64, 48, 4, config)
    assert got.device.type == "cuda" and megakernel.kernel_launches == before
    got = got.cpu()
    assert torch.isfinite(got).all()
    assert (_tm(got) - _tm(want)).abs().mean().item() <= 5e-4
    assert abs(got[..., :3].mean() / want[..., :3].mean() - 1).item() <= 0.01


@pytest.mark.parametrize("kind", ["silhouette", "shadow"])
def test_boundary_grads_on_the_card_equal_the_cpu(device, kind):
    """silhouette_loss_grads and shadow_silhouette_grads at 32x32 with the
    same key on the card and on the CPU: relative L2 gap <= 1e-3, no sign
    flipped."""
    from kajo_tpu_torch.diff import edges
    from kajo_tpu_torch.ops.rng import CounterKey
    from kajo_tpu_torch.scene.testscene import build_shadow_scene, build_silhouette_scene

    cot = torch.from_numpy(np.random.default_rng(4).normal(size=(32, 32, 3)).astype(np.float32))
    fn, scene_of, config, n = {
        "silhouette": (edges.silhouette_loss_grads, lambda d: build_silhouette_scene(0.3, -0.2, device=d),
                       RenderConfig(max_depth=2), 256),
        "shadow": (edges.shadow_silhouette_grads, lambda d: build_shadow_scene(2.0, d), RenderConfig(max_depth=1), 4),
    }[kind]
    got = fn(scene_of(device), CounterKey(1), cot.to(device), 32, 32, config, n)
    want = fn(scene_of("cpu"), CounterKey(1), cot, 32, 32, config, n)
    for g, w in zip(got, want):
        g = g.cpu()
        assert torch.isfinite(g).all() and float(w.abs().max()) > 0
        assert float(torch.linalg.norm(g - w) / torch.linalg.norm(w)) <= 1e-3
        big = w.abs() > 0.01 * w.abs().max()
        assert torch.equal(torch.sign(g[big]), torch.sign(w[big]))


def _streamed_field(device):
    """A 1,500-sphere field (above STREAM_THRESHOLD: K5 traces it, K6 its
    shadow rays)."""
    scene = random_spheres_scene(1500, seed=21, extent=15.0, n_lights=2, aspect_ratio=W / H, device=device)
    assert geometry.prepare_scene(scene).stream_packed is not None
    return scene


def test_streamed_budget_gradient_on_the_card_matches_dense(device, monkeypatch):
    """Every radius's gradient through the budget engine on the card: on a
    streamed scene K5 answers (never its plain version) and the nearest
    hit's VJP runs on the card; against the same gradient through the dense
    trace on the card (the same winners, so only the order of the sums
    differs): relative L2 gap <= 1e-4. (Against the CPU the gradients part
    by ~5% here: a few of the 768 lanes take other paths where CUDA's and
    the CPU's transcendentals round apart.)"""
    from kajo_tpu_torch.diff.inverse import apply_params

    scene = _streamed_field(device)

    def radius_grad():
        r = scene.sphere_radius.clone().requires_grad_(True)
        img = wavefront.render_pass_budget(apply_params(scene, {"sphere_radius": r}), 11, W, H, SPP,
                                           RenderConfig(max_depth=2))
        return torch.autograd.grad(img[..., :3].mean(), [r])[0]

    with monkeypatch.context() as m:
        m.setattr(stream_trace, "nearest_sphere_plain", lambda *a: pytest.fail("the card took plain K5"))
        before = stream_trace.nearest_launches
        got = radius_grad()
        assert stream_trace.nearest_launches > before
    monkeypatch.setattr(geometry, "STREAM_THRESHOLD", 10**9)
    want = radius_grad()
    assert torch.isfinite(got).all() and float(want.abs().max()) > 0
    assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) <= 1e-4


def _budget_radius_grad(scene, mask=None):
    """The budget image (32x24, 4 spp, depth 2, seed 11) and the gradient of
    the mean of its pixels (those of ``mask`` only) with respect to every
    radius, both on the CPU."""
    from kajo_tpu_torch.diff.inverse import apply_params

    r = scene.sphere_radius.clone().requires_grad_(True)
    img = wavefront.render_pass_budget(apply_params(scene, {"sphere_radius": r}), 11, W, H, SPP,
                                       RenderConfig(max_depth=2))[..., :3]
    weight = 1.0 if mask is None else mask.to(img.device, torch.float32)[..., None]
    (g,) = torch.autograd.grad((img * weight).mean(), [r])
    return img.detach().cpu(), g.cpu()


def test_budget_gradient_card_cpu_gap_is_not_the_vjp(device, monkeypatch):
    """Why the test above holds the card's streamed gradient against the
    card's dense one and not against the CPU. On the same field, on each
    device, the streamed trace (K5 and the nearest hit's VJP) and the dense
    trace (no VJP) give the same gradient within 1e-4, and the card-CPU gap
    is the same on both traces within 1% of itself: so the gap does not come
    from the VJP. A report, no bar: how many lanes (one a pixel) part in the
    budget image by more than 1e-3 and 1e-5 relative, and the streamed
    card-CPU gap with those pixels left out of the loss (``-s``)."""
    scenes = {"cuda": _streamed_field(device), "cpu": _streamed_field(torch.device("cpu"))}

    def runs(traces, mask=None):
        out = {}
        for trace in traces:
            with monkeypatch.context() as m:
                if trace == "dense":
                    m.setattr(geometry, "STREAM_THRESHOLD", 10**9)
                for dev, scene in scenes.items():
                    out[trace, dev] = _budget_radius_grad(scene, mask)
        return out

    def gap(a, b):
        return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))

    out = runs(("streamed", "dense"))
    g = {k: v[1] for k, v in out.items()}
    gaps = {t: gap(g[t, "cuda"], g[t, "cpu"]) for t in ("streamed", "dense")}
    same = {dev: gap(g["streamed", dev], g["dense", dev]) for dev in scenes}
    report = []
    for rtol in (1e-3, 1e-5):
        a, b = out["streamed", "cuda"][0], out["streamed", "cpu"][0]
        parted = ((a - b).abs() > rtol * torch.clamp_min(b.abs(), 1.0)).any(-1)
        kept = runs(("streamed",), ~parted)
        report.append(f"{int(parted.sum())} of {W * H} lanes part by more than {rtol:g}, the streamed gap "
                      f"without them {gap(kept['streamed', 'cuda'][1], kept['streamed', 'cpu'][1]):.3e}")
    print(f"budget radius gradient card vs CPU: streamed {gaps['streamed']:.4e}, dense {gaps['dense']:.4e}; "
          f"streamed vs dense on the card {same['cuda']:.3e}, on the CPU {same['cpu']:.3e}; " + "; ".join(report))
    assert all(v <= 1e-4 for v in same.values()), same
    assert abs(gaps["streamed"] - gaps["dense"]) <= 0.01 * gaps["dense"], gaps


def test_jax_engine_repeats_bit_for_bit(device):
    """Engine jax on a streamed scene (K5 forward, the VJP's sums backward)
    and on a dense one: two runs of a few Adam steps give the same losses
    and parameters, bit for bit (no float atomics on the path)."""
    from kajo_tpu_torch.diff.inverse import InverseRenderer

    for scene in (_streamed_field(device), parser.load(os.path.join(DATA, "caustics.json"), W / H, device)):
        target = wavefront.render_pass_fast(scene, 1, W, H, 16, RenderConfig(max_depth=2))
        runs = []
        for _ in range(2):
            inv = InverseRenderer(scene, target, W, H, spp=SPP, config=RenderConfig(max_depth=2), loss_clip=1.0,
                                  param_spec=("sphere_transform", "sphere_radius", "diffuse"), engine="jax", seed=3)
            losses = [inv.step() for _ in range(3)]
            runs.append((losses, {k: v.detach().clone() for k, v in inv.params.items()}))
        assert runs[0][0] == runs[1][0]
        for k in runs[0][1]:
            assert torch.equal(runs[0][1][k].view(torch.int32), runs[1][1][k].view(torch.int32)), k
