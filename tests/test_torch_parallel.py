"""The port's distribution (``kajo_tpu_torch.parallel``) on the CPU.

One module fixture starts one gloo process group of 3 processes
(``tests/_torch_parallel_worker.py``, a ``FileStore`` in ``tmp_path``, one
PyTorch thread each); every sharded check runs inside it and rank 0's
results come back here. The tests then hold:

  * K1 (its plain twin here) and the wavefront (a dense scene) sharded over
    3 ranks equal the unsharded passes bit for bit, at 16x12, at 13x7 (91
    lanes: the last block pads) and at 2x1 (a block of pad lanes only), and
    over 2 ranks and 1 at 13x7;
  * the parity engine sharded over 3 ranks equals itself at world size 1
    and the unsharded ``render_pass`` bit for bit (a counter key), and with
    the JAX package's draws is within rtol 1e-3, atol 1e-5 of kajo_tpu's
    ``render_pass_sharded`` on 2 devices of the conftest's virtual mesh, 99%
    of it within ``tests/test_parallel.py``'s rtol 1e-4 (the two packages'
    rounding, not the sharding: see the test);
  * the object-sharded wavefront (67 spheres, which 3 does not divide; a
    non-rigid field; shards streamed through the plain K5) within rtol 1e-4,
    atol 1e-5 of the unsharded one-lane-a-pixel wavefront (bit for bit so
    far), and against kajo_tpu's ``render_pass_fast_objsharded`` on 2
    devices no further than the two packages' unsharded passes are apart,
    with the pixels that differ at all printed;
  * ``render_loss``'s gradient under the mesh equal to the unsharded parity
    loss's within rtol 1e-5 (a gradient summed once per rank too many would
    be 3x), and three ``InverseRenderer(mesh=...)`` steps leaving the same
    parameters on every rank.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax_goldens import replayed
from torch_port import REPO, JaxKey, mean_rel, tm_mad

from kajo_tpu.models.integrator import RenderConfig as JaxRenderConfig
from kajo_tpu.models.wavefront import render_pass_fast as jax_render_pass_fast
from kajo_tpu.ops.rng import seed_from_key
from kajo_tpu.parallel.objshard import render_pass_fast_objsharded as jax_objsharded
from kajo_tpu.parallel.render import make_mesh as jax_make_mesh
from kajo_tpu.parallel.render import render_pass_sharded as jax_render_pass_sharded
from kajo_tpu.scene.procedural import random_spheres_scene as jax_random_spheres_scene
from kajo_tpu.scene.testscene import build_test_scene as jax_build_test_scene

WORLD = 3
W, H, SPP, DEPTH = 16, 12, 4, 2
PARITY_KEY, OBJ_KEY = 4, 11
RTOL, ATOL = 1e-4, 1e-5
SIZES = ("16x12", "13x7", "2x1")


def _parity_draws():
    """The JAX package's uniforms of a 16x12, 4 spp parity pass with key
    PARITY_KEY, by fold path (see the worker's TableKey)."""
    key = JaxKey(PARITY_KEY)
    nu = 3 + 3 * 1 + 2  # build_test_scene has one light
    table = {}
    for idx in range(SPP):
        table[f"{idx}"] = key.fold_in(idx).uniform((2, W * H), "cpu").numpy()
        for depth in range(DEPTH + 1):
            table[f"{idx}/7919/{depth}"] = key.fold_in(idx).fold_in(7919).fold_in(depth).uniform((nu, W * H),
                                                                                                 "cpu").numpy()
    return table


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    inp = str(tmp / "draws.npz")
    np.savez(inp, obj_seed=int(seed_from_key(jax.random.PRNGKey(OBJ_KEY))), **_parity_draws())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    worker = os.path.join(REPO, "tests", "_torch_parallel_worker.py")
    procs = [
        subprocess.Popen([sys.executable, worker, str(r), str(WORLD), str(tmp / "store"), inp, str(tmp)],
                         env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)
    ]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
    res = dict(np.load(tmp / "results.npz"))
    print(f"the sharded checks took {float(res['seconds']):.1f} s on rank 0")
    return res


def _differ(got, want):
    return int((np.abs(got - want) > 0).any(-1).sum())


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("engine", ["mega", "fast"])
def test_lane_sharded_equals_unsharded(sharded, engine, size):
    """mega (the plain K1) and fast (a dense scene) over 3 ranks equal the
    unsharded pass bit for bit, pad lanes and an empty block included."""
    got, want = sharded[f"{engine}/{size}"], sharded[f"{engine}/{size}/whole"]
    w, h = map(int, size.split("x"))
    assert got.shape == (h, w, 4) and np.isfinite(got).all()
    assert got[..., :3].max() > 0 or size == "2x1"
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("engine", ["mega", "fast"])
def test_lane_sharded_at_other_world_sizes(sharded, engine, world):
    """The same passes at 13x7 on a group of 2 of the 3 ranks (91 lanes pad
    to 92) and on a group of one equal the unsharded pass bit for bit."""
    np.testing.assert_array_equal(sharded[f"{engine}/13x7/world{world}"], sharded[f"{engine}/13x7/whole"])


def test_no_launch_on_the_cpu(sharded):
    """The CPU runs K1's plain twin: no kernel launch is counted."""
    assert int(sharded["launches/mega"]) == 0


def test_parity_sharded_equals_world1_and_unsharded(sharded):
    got = sharded["parity"]
    assert got.shape == (H, W, 4) and np.isfinite(got).all() and got[..., :3].mean() > 0
    np.testing.assert_array_equal(got, sharded["parity/world1"])
    np.testing.assert_array_equal(got, sharded["parity/whole"])
    np.testing.assert_array_equal(sharded["engine/parity"], got)
    np.testing.assert_array_equal(sharded["image"], sharded["image/whole"])


def test_engine_auto_is_fast_on_the_cpu(sharded):
    np.testing.assert_array_equal(sharded["engine/auto"], sharded["fast/16x12/whole"])


@replayed
def kajo_parity_sharded(js, key, w, h, spp, depth):
    """kajo_tpu's render_pass_sharded over 2 of the virtual devices."""
    return {"img": jax_render_pass_sharded(js, key, w, h, spp, JaxRenderConfig(max_depth=depth),
                                           jax_make_mesh(jax.devices()[:2]))}


def test_parity_sharded_matches_kajo_tpu(sharded):
    """With the JAX package's draws, the port's sharded parity pass over 3
    ranks against kajo_tpu's render_pass_sharded over 2 devices.

    The sharded pass equals the port's unsharded one bit for bit (above),
    which agrees with kajo_tpu's to ~1e-5 of a lane and not to the bit
    (``tests/test_torch_integrator.py``: the two packages' sines, cosines and
    fused products round differently, and Phong exponents amplify an ulp).
    At 16x12 one value of 768 exceeds rtol 1e-4 (by 2.9e-5, relative
    3.5e-4). The bars: every value within rtol 1e-3, atol 1e-5, and at least
    99% within kajo_tpu's rtol 1e-4, atol 1e-5."""
    want = kajo_parity_sharded(jax_build_test_scene(W / H), jax.random.PRNGKey(PARITY_KEY), W, H, SPP, DEPTH)["img"]
    got = sharded["parity/jax-draws"]
    within = np.abs(got - want) <= ATOL + RTOL * np.abs(want)
    print(f"parity vs kajo_tpu: {_differ(got, want)} of {W * H} pixels differ at all, "
          f"{int((~within).sum())} of {got.size} values outside rtol {RTOL}, atol {ATOL}, "
          f"largest gap {np.abs(got - want).max():.3e}")
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=ATOL)
    assert within.mean() >= 0.99


@pytest.mark.parametrize("name", ["rigid", "jitter", "streamed"])
def test_objsharded_matches_unsharded(sharded, name):
    """Against the unsharded wavefront with one lane a pixel; streamed:
    every shard of 22-23 spheres above a STREAM_THRESHOLD of 16 (the plain
    K5 on each rank, shadow rays by the nearest hit), against the unsharded
    streamed pass (the whole scene's packing, shadow rays by the plain K6)."""
    if name == "streamed":
        assert bool(sharded["obj/streamed/shard-packed"])
    got, want = sharded[f"obj/{name}"], sharded[f"obj/{name}/whole"]
    assert got.shape == (H, W, 4) and np.isfinite(got).all() and got[..., :3].mean() > 0
    print(f"objsharded {name}: {_differ(got, want)} of {W * H} pixels differ at all, "
          f"largest gap {np.abs(got - want).max():.3e}")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@replayed
def kajo_objsharded(js, key, w, h, spp, depth):
    """kajo_tpu's render_pass_fast_objsharded over 2 of the virtual devices,
    and its unsharded render_pass_fast."""
    config = JaxRenderConfig(max_depth=depth)
    return {"sharded": jax_objsharded(js, key, w, h, spp, config, jax_make_mesh(jax.devices()[:2])),
            "whole": jax_render_pass_fast(js, key, w, h, spp, config)}


@pytest.mark.parametrize("name", ["rigid", "jitter"])
def test_objsharded_matches_kajo_tpu(sharded, name):
    """kajo_tpu's render_pass_fast_objsharded over 2 devices (dense shards)
    with key OBJ_KEY, whose u32 seed the port's pass took.

    The port's object-sharded pass equals its unsharded wavefront bit for
    bit (above), and that agrees with kajo_tpu's to the bars of
    ``tests/test_torch_wavefront.py``, not to rtol 1e-4 (the two packages'
    transcendentals and dense dot products round differently; here up to
    7e-4 of a value). So the bars: kajo_tpu's sharded pass within its own
    rtol 1e-4, atol 1e-5 of its unsharded one, the port's within a
    tone-mapped MAD of 5e-4 and a mean relative gap of 1% of kajo_tpu's, and
    the two packages' sharded passes no further apart than their unsharded
    ones: sharding adds no gap of its own."""
    kw = dict(n_lights=2) if name == "rigid" else dict(n_lights=1, scale_jitter=0.5)
    n, seed, extent = (67, 21, 12.0) if name == "rigid" else (31, 22, 10.0)
    scene = jax_random_spheres_scene(n, seed=seed, extent=extent, aspect_ratio=W / H, **kw)
    ref = kajo_objsharded(scene, jax.random.PRNGKey(OBJ_KEY), W, H, SPP, DEPTH)
    want, jax_whole = ref["sharded"], ref["whole"]
    got, port_whole = sharded[f"obj/{name}"], sharded[f"obj/{name}/whole"]
    gap, whole_gap = np.abs(got - want).max(), np.abs(port_whole - jax_whole).max()
    outside = int((np.abs(got - want) > ATOL + RTOL * np.abs(want)).sum())
    print(f"objsharded {name} vs kajo_tpu: {_differ(got, want)} of {W * H} pixels differ at all, "
          f"{outside} of {got.size} values outside rtol {RTOL}, atol {ATOL}, largest gap {gap:.3e} "
          f"(unsharded: {whole_gap:.3e}), tone-mapped MAD {tm_mad(got, want):.3e}")
    np.testing.assert_allclose(want, jax_whole, rtol=RTOL, atol=ATOL)
    assert tm_mad(got, want) <= 5e-4 and mean_rel(got, want) <= 0.01
    assert gap <= whole_gap + ATOL


def test_render_loss_gradient_is_the_whole_images(sharded):
    """render_loss under the mesh: the loss and every parameter's gradient
    equal the unsharded parity loss's (rtol 1e-5), not 3x them."""
    np.testing.assert_allclose(sharded["grad/loss"], sharded["grad/loss/whole"], rtol=1e-5)
    for name in ("diffuse", "sphere_transform"):
        got, want = sharded[f"grad/{name}"], sharded[f"grad/{name}/whole"]
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_inverse_renderer_steps_alike_on_every_rank(sharded):
    assert str(sharded["inverse/engine"]) == "jax"
    assert np.isfinite(sharded["inverse/losses"]).all()
    params = sharded["inverse/params"]
    for r in range(1, WORLD):
        np.testing.assert_array_equal(params[r], params[0])
