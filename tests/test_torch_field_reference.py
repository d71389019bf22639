"""The benchmark's plain reference of the sphere field
(``benchmark/reference/field.py``) against the port's streamed wavefront,
and the wavefront's spans and counters.

On the CPU the port's ``render_passes_fast`` traces a field above
``STREAM_THRESHOLD`` spheres through the plain K5/K6, and the frozen
reference renders the same bits; on the card (marker ``cuda``; ``python -m
pytest tests/test_torch_field_reference.py --noconftest -m cuda``) K5/K6
do. Imports no JAX.
"""

import numpy as np
import pytest
import torch

from benchmark.reference import field
from kajo_tpu_torch.models import wavefront
from kajo_tpu_torch.models.integrator import RenderConfig
from kajo_tpu_torch.ops import stream_trace
from kajo_tpu_torch.scene.procedural import random_spheres_scene
from kajo_tpu_torch.scene.testscene import build_test_scene

torch.set_num_threads(1)

N_SPHERES = 2048  # above STREAM_THRESHOLD: streamed
SEED = 2**31 + 77
SPANS = ("kajo.wavefront.prepare", "kajo.wavefront.iteration", "kajo.wavefront.flag")


def _bits(x):
    return x.contiguous().view(torch.int32)


def _both(width, height, one_light, device, passes=2, first=3):
    """The port's batch and the reference's whole render of the same field
    -> ([H, W, 4], [H, W, 4])."""
    scene = random_spheres_scene(N_SPHERES, seed=SEED, aspect_ratio=width / height, device=device)
    got = wavefront.render_passes_fast(scene, SEED, first, width, height, 4, passes,
                                       RenderConfig(max_depth=2, one_light_nee=one_light))
    fl = field.prepare(field.field_arrays(N_SPHERES, SEED, aspect_ratio=width / height), device)
    want = field.render_batch(fl, SEED, first, passes, width, height, 4,
                              field.Estimator(max_depth=2, one_light_nee=one_light))
    return got, want.reshape(height, width, 4)


@pytest.mark.parametrize("one_light", [True, False], ids=["one-light", "all-lights"])
def test_fast_batch_equals_the_reference(one_light):
    got, want = _both(32, 24, one_light, "cpu")
    assert torch.equal(_bits(got), _bits(want))
    assert float(want[..., :3].mean()) > 0 and bool((want[..., 3] == 2.0).all())


def test_tile_subset_equals_the_whole_render():
    """Two screen tiles of an 80x24 image (both cut by its edges): every
    lane of their pixels, under its own id, gives the whole render's bits."""
    w, h = 80, 24
    fl = field.prepare(field.field_arrays(N_SPHERES, SEED, aspect_ratio=w / h), "cpu")
    est = field.Estimator(max_depth=2, one_light_nee=True)
    whole = field.render_batch(fl, SEED, 0, 1, w, h, 4, est)
    assert field.n_tiles(w, h) == 2
    for tiles in ([0], [1], [0, 1]):
        px = field.tile_pixels(w, h, tiles)
        sub = field.render_batch(fl, SEED, 0, 1, w, h, 4, est, field.pixel_lanes(w, h, px))
        assert torch.equal(_bits(sub), _bits(whole[torch.as_tensor(px)]))
    assert sorted(field.tile_pixels(w, h, [0, 1]).tolist()) == list(range(w * h))


def test_field_arrays_equal_the_generator():
    scene = random_spheres_scene(N_SPHERES, seed=SEED, aspect_ratio=1.5, device="cpu")
    arr = field.field_arrays(N_SPHERES, SEED, aspect_ratio=1.5)
    pairs = {
        "view": scene.camera.transform, "projection": scene.camera.projection, "background": scene.background,
        "plane_transform": scene.plane_transform, "sphere_transform": scene.sphere_transform,
        "sphere_radius": scene.sphere_radius,
    }
    pairs.update({f"materials.{k}": getattr(scene.materials, k) for k in arr["materials"]})
    for key, port in pairs.items():
        ref = arr["materials"][key.split(".")[1]] if key.startswith("materials.") else arr[key]
        assert np.array_equal(np.asarray(ref, np.float32), port.numpy()), key
    assert arr["light_indices"] == scene.light_indices and arr["rigid"] == scene.rigid_spheres is True


def test_counters_count_bodies_and_flag_reads():
    scene = build_test_scene(4 / 3, "cpu")
    before = (wavefront.iterations, wavefront.flag_reads, wavefront.prepare_seconds)
    _, iters, _ = wavefront.render_pass_fast_stats(scene, 9, 8, 6, 4, RenderConfig(max_depth=3))
    assert iters > 0
    assert wavefront.iterations - before[0] == iters
    assert wavefront.flag_reads - before[1] == iters + 1  # the last read ends the loop
    wavefront.render_passes_fast(scene, 9, 0, 8, 6, 4, 2, RenderConfig(max_depth=3))
    assert wavefront.prepare_seconds > before[2]


def test_spans_in_a_profiled_run():
    from torch.profiler import ProfilerActivity, profile

    scene = build_test_scene(4 / 3, "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        wavefront.render_passes_fast(scene, 9, 0, 4, 3, 1, 1, RenderConfig(max_depth=1))
    names = {e.key: e.count for e in prof.key_averages()}
    assert all(s in names for s in SPANS), sorted(k for k in names if k.startswith("kajo"))
    assert names["kajo.wavefront.prepare"] == 1
    assert names["kajo.wavefront.flag"] == names["kajo.wavefront.iteration"] + 1  # the last read ends the loop


@pytest.mark.cuda
@pytest.mark.parametrize("one_light", [True, False], ids=["one-light", "all-lights"])
def test_k5_k6_batch_equals_the_reference_on_the_card(one_light):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launches = stream_trace.nearest_launches, stream_trace.occluded_launches
    got, want = _both(128, 96, one_light, torch.device("cuda"))
    assert stream_trace.nearest_launches > launches[0] and stream_trace.occluded_launches > launches[1]
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("n_spheres", [N_SPHERES, 64], ids=["streamed", "dense"])
def test_graphed_batch_equals_the_eager_loop_on_the_card(n_spheres):
    """On the card ``render_passes_fast`` replays the loop's body as a CUDA
    graph: the eager loop's bits, bodies, flag reads and K5/K6 runs. The
    second field has the first's layout, so its batch replays the first's
    graph on the refilled preparation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from kajo_tpu_torch.ops.geometry import prepare_scene
    from kajo_tpu_torch.ops.rng import pass_seed

    w, h, passes = 128, 96, 3
    cfg = RenderConfig(max_depth=2, one_light_nee=True)

    def counts():
        return [wavefront.iterations, wavefront.flag_reads, stream_trace.nearest_launches,
                stream_trace.occluded_launches]

    graphs = []
    for seed in (SEED, SEED + 1):
        scene = random_spheres_scene(n_spheres, seed=seed, aspect_ratio=w / h, device=torch.device("cuda"))
        c0 = counts()
        got = wavefront.render_passes_fast(scene, seed, 3, w, h, 4, passes, cfg)
        c1 = counts()
        graphs.append(wavefront._LOOPS[torch.cuda.current_device()].graph)
        prep = prepare_scene(scene)
        want = torch.zeros_like(got)
        for i in range(passes):
            want += wavefront._pass(prep, pass_seed(seed, 3 + i), w, h, 4, cfg)[0]
        c2 = counts()
        assert torch.equal(_bits(got), _bits(want))
        assert [b - a for a, b in zip(c0, c1)] == [b - a for a, b in zip(c1, c2)]
        assert c1[0] > c0[0] + passes
    assert graphs[0] is graphs[1]


def test_graph_key_and_own_preparation():
    """A graphed loop keeps its own copy of the preparation, and its key
    holds every tensor's shape: fields of one size share a key, another
    size does not."""
    from kajo_tpu_torch.ops.geometry import prepare_scene

    preps = [prepare_scene(random_spheres_scene(n, seed=s, device="cpu")) for n, s in
             ((N_SPHERES, 1), (N_SPHERES, 2), (N_SPHERES + 1, 1))]
    assert wavefront._layout(preps[0]) == wavefront._layout(preps[1]) != wavefront._layout(preps[2])
    own = wavefront._cloned(preps[0])
    for (name, a), (_, b) in zip(wavefront._fields(own), wavefront._fields(preps[0])):
        if isinstance(b, torch.Tensor):
            assert torch.equal(a, b) and a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr(), name
        else:
            assert a == b, name
    assert "materials.diffuse" in dict(wavefront._fields(own)) and "camera.origin" in dict(wavefront._fields(own))


# operations that read the device back or build a tensor from host data:
# each breaks a CUDA graph's capture
HOST_OPS = ("aten.lift_fresh", "aten.lift_fresh_copy", "aten._local_scalar_dense", "aten.nonzero",
            "aten.masked_select", "aten.item")


@pytest.mark.parametrize("n_spheres", [N_SPHERES, 64], ids=["streamed", "dense"])
def test_body_never_reads_or_copies_from_the_host(n_spheres, monkeypatch):
    """The loop's body, which ``render_passes_fast`` captures as a CUDA
    graph on the card, runs no operation that reads the device back or
    builds a tensor from host data, and indexes by no mask. On the card
    K5/K6 are launches; here stand-ins of their shapes replace their plain
    versions, whose scans index by masks."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from kajo_tpu_torch.ops.geometry import prepare_scene

    monkeypatch.setattr(stream_trace, "nearest_sphere_plain",
                        lambda rigid, o, d, bound, *_: (bound.clone(), torch.full_like(bound, -1, dtype=torch.int32)))
    monkeypatch.setattr(stream_trace, "occluded_sphere_plain", lambda rigid, o, d, t_cut, *_: t_cut.clone())
    seen = []

    class Spy(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = str(func.overloadpacket)
            masked = name == "aten.index" and any(i is not None and i.dtype == torch.bool for i in args[1])
            if name in HOST_OPS or masked:
                seen.append(str(func))
            return func(*args, **(kwargs or {}))

    scene = random_spheres_scene(n_spheres, seed=SEED, aspect_ratio=4 / 3, device="cpu")
    prep = prepare_scene(scene)
    assert (prep.stream_packed is not None) == (n_spheres == N_SPHERES)
    for one_light in (True, False):
        lane, pix, s_lo, s_hi, _ = wavefront.lane_layout(prep, 8, 6, 4)
        state, _, body = wavefront._make_loop(prep, lane, wavefront._seed_tensor(SEED, "cpu"), 8, 6, 4, 2,
                                              RenderConfig(max_depth=2, one_light_nee=one_light), pix, s_lo, s_hi)
        with Spy():
            for _ in range(2):
                state = body.step(state)
    assert seen == []
