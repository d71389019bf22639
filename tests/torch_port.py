"""Shared helpers of the tests that hold the PyTorch port (``kajo_tpu_torch``)
against the JAX package (``kajo_tpu``): one scene handed to both packages,
the JAX megakernel run as its own tests run it on the CPU (Pallas interpret
mode), and the image metrics of the comparisons. The JAX package's outputs
come through ``jax_goldens.cached``: replayed from ``tests/goldens/jax_ref/``
where stored, else computed."""

import dataclasses
import os

import jax
import numpy as np
import torch
from jax.experimental.pallas import tpu as pltpu

from kajo_tpu.models.integrator import RenderConfig as JaxRenderConfig
from kajo_tpu.ops.pallas import megakernel as jax_megakernel
from kajo_tpu.ops.rng import seed_from_key
from kajo_tpu.scene import parser as jax_parser
from kajo_tpu.scene.types import Camera as JaxCamera
from kajo_tpu.scene.types import make_scene as jax_make_scene
from kajo_tpu_torch.scene.testscene import mirror_cluster_parts, two_light_scene_parts
from kajo_tpu_torch.scene.types import scene_from_numpy
from jax_goldens import cached, keep, lookup, replayed, source

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data")
GOLDENS = os.path.join(REPO, "tests", "goldens")

# the tests run one process per core (pytest-xdist): one intra-op thread
# each keeps PyTorch's thread pools from oversubscribing the cores
torch.set_num_threads(1)


def to_port(jax_scene, device="cpu"):
    """The port's Scene holding the same arrays as a kajo_tpu Scene."""
    return scene_from_numpy(dataclasses.asdict(jax.tree.map(np.asarray, jax_scene)), device)


def jax_scene(name, aspect):
    """An in-repo scene file loaded by the JAX package's parser."""
    return jax_parser.load(os.path.join(DATA, name), aspect)


def jax_two_light_scene(aspect=1.5):
    view, projection, background, planes, spheres = two_light_scene_parts(aspect)
    return jax_make_scene(JaxCamera(view, projection), background, planes, spheres)


def jax_mirror_cluster(aspect=4 / 3):
    view, projection, background, planes, spheres = mirror_cluster_parts(aspect)
    return jax_make_scene(JaxCamera(view, projection), background, planes, spheres)


def jax_pass(scene, key_int, w, h, spp, **config):
    """The JAX megakernel pass in interpret mode -> (image, u32 seed): the
    port takes the same seed as a plain integer."""
    out = jax_megakernel_pass(scene, key_int, w, h, spp, config)
    return out["img"], int(out["seed"])


@replayed
def jax_megakernel_pass(scene, key_int, w, h, spp, config):
    key = jax.random.PRNGKey(key_int)
    with pltpu.force_tpu_interpret_mode():
        img = jax_megakernel.render_pass_megakernel(scene, key, w, h, spp, JaxRenderConfig(**config))
    return {"img": np.asarray(img), "seed": np.uint32(seed_from_key(key))}


def jax_grad_scene(name, aspect):
    """A scene of the gradient tests, built by the JAX package: a file of
    ``data/``, ``"two-light"`` (two lights, for one-light NEE) or
    ``"random40"`` (``random_spheres_scene(40, seed=11, extent=10,
    n_lights=2)``: K = 43 objects, the Pallas kernel's table path) or
    ``"mirror-cluster"`` (27 mirror spheres, for K4's slot rule)."""
    if name == "two-light":
        return jax_two_light_scene(aspect)
    if name == "mirror-cluster":
        return jax_mirror_cluster(aspect)
    if name == "random40":
        from kajo_tpu.scene.procedural import random_spheres_scene

        return random_spheres_scene(40, seed=11, extent=10.0, n_lights=2, aspect_ratio=aspect)
    return jax_scene(name, aspect)


# the reference scripts' XLA: no fused multiply-add (see tests/_jax_stream_ref.py)
SSE42 = "--xla_cpu_max_isa=SSE4_2"
# a reference subprocess's limit: about 3x the longest one's time, ~200 s for
# test_torch_inverse.py's loss job beside 5 other test processes on 8 cores
REF_TIMEOUT = 600


def _ref_env():
    return dict(os.environ, XLA_FLAGS=SSE42, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")


def jax_grad_reference(tmp_dir, jobs, arrays):
    """The JAX gradient kernels on ``jobs`` (see ``tests/_jax_grad_ref.py``):
    K2 ``render_pass_megakernel_jvp``, K3 ``material_grads``, K4
    ``geometry_grads`` and the loss of an engine ``mega`` step, in Pallas
    interpret mode with their u32 seeds -> {"<job>/<field>": array}.

    They run in a subprocess whose XLA fuses no multiply-add (SSE4.2), on
    the port's packed scene of each job's scene (``arrays["packed/<scene>"]``,
    see :func:`port_packed`), so both packages do the same arithmetic. The
    key holds the jobs, the arrays, the JAX scenes the script builds and its
    source."""
    import json
    import subprocess
    import sys

    script = os.path.join(REPO, "tests", "_jax_grad_ref.py")
    scenes = {f"{j['scene']}@{j['w']}x{j['h']}": jax_grad_scene(j["scene"], j["w"] / j["h"]) for j in jobs}
    inputs = dict(jobs=json.dumps(jobs, sort_keys=True), arrays=arrays, scenes=scenes, source=source(script))

    def compute():
        inp, out, jobs_path = (os.path.join(str(tmp_dir), f) for f in ("in.npz", "out.npz", "jobs.json"))
        np.savez(inp, **arrays)
        with open(jobs_path, "w") as f:
            json.dump(jobs, f)
        r = subprocess.run([sys.executable, script, inp, out, jobs_path], env=_ref_env(), cwd=REPO,
                           capture_output=True, text=True, timeout=REF_TIMEOUT)
        assert r.returncode == 0, (r.stdout + r.stderr)[-3000:]
        return dict(np.load(out))

    return cached("_jax_grad_ref", inputs, compute, xla_flags=SSE42)


def jax_script_reference(tmp_dir, script, cases, *helpers):
    """``tests/<script> OUT.npz <case>`` for each of ``cases``, a reference
    script that builds its own scene and rays from seeds, each case in its
    own SSE4.2 subprocess, all at once -> {case: {name: array}}. The key
    holds the case and the source of the script and of the ``helpers``
    (files of ``tests/``) it imports."""
    import subprocess
    import sys

    path = os.path.join(REPO, "tests", script)
    text = source(path, *(os.path.join(REPO, "tests", h) for h in helpers))
    found = {c: lookup(script, dict(case=c, source=text), SSE42) for c in cases}
    procs = {
        c: subprocess.Popen([sys.executable, path, os.path.join(str(tmp_dir), f"{c}.npz"), c], env=_ref_env(),
                            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c, (_, out) in found.items() if out is None
    }
    try:
        for c, p in procs.items():
            log, _ = p.communicate(timeout=REF_TIMEOUT)
            assert p.returncode == 0, log[-3000:]
            found[c] = (found[c][0], keep(found[c][0], dict(np.load(os.path.join(str(tmp_dir), f"{c}.npz")))))
    finally:
        for p in procs.values():
            p.kill()
    return {c: out for c, (_, out) in found.items()}


def jax_kernel_reference(tmp_dir, kind, cases, w, h, spp, key, arrays=None, **job):
    """One JAX gradient kernel (``kind``: k2, k3, k4 or loss) on each of
    ``cases`` = {case: (scene name, RenderConfig fields[, the case's own job
    fields])}, through :func:`jax_grad_reference` with the port's packed
    scenes; ``arrays`` and ``job`` (a cotangent's or target's array name,
    tangents, ...) go to every job -> {"<case>/<field>": array,
    "<case>/seed": u32 seed}."""
    arrays = dict(arrays or {})
    jobs = []
    for case, (name, cfg, *own) in cases.items():
        arrays[f"packed/{name}"] = port_packed(to_port(jax_grad_scene(name, w / h)))
        jobs.append(dict(job, **(own[0] if own else {}), name=case, kind=kind, scene=name, w=w, h=h, spp=spp,
                         config=cfg, key=key))
    return jax_grad_reference(tmp_dir, jobs, arrays)


def port_packed(scene, config=None):
    """The port's packed scene (``pack_scene(prepare_scene(.))``) as numpy."""
    from kajo_tpu_torch.models.integrator import RenderConfig
    from kajo_tpu_torch.ops.megakernel import prepare_pass

    return prepare_pass(scene, 1, 1, 1, config or RenderConfig()).packed.numpy()


class JaxKey:
    """A ``jax.random`` key with the port's key API (``fold_in``, ``split``,
    ``uniform``, ``seed``): the port's parity engine and boundary terms then
    draw the JAX package's uniforms for the same key, handed over as numpy
    arrays, and ``render_image_fast`` takes its ``seed_from_key``."""

    def __init__(self, key):
        self.key = jax.random.PRNGKey(key) if isinstance(key, int) else key

    def fold_in(self, i):
        return JaxKey(jax.random.fold_in(self.key, i))

    def split(self, n=2):
        return [JaxKey(k) for k in jax.random.split(self.key, n)]

    def seed(self):
        return int(seed_from_key(self.key))

    def uniform(self, shape, device):
        return torch.from_numpy(np.array(jax.random.uniform(self.key, shape, dtype=np.float32))).to(device)


def rel_l2(got, want):
    """||got - want|| / ||want|| over every entry, in float64."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def tm(x):
    """Clamp and gamma, as the image is displayed."""
    return np.clip(x[..., :3], 0, 1) ** (1 / 2.2)


def tm_mad(a, b):
    return float(np.abs(tm(a) - tm(b)).mean())


def mean_rel(a, b):
    return float(abs(a[..., :3].mean() - b[..., :3].mean()) / b[..., :3].mean())
