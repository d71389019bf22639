"""Reference gradients of the JAX package's megakernels (Pallas interpret
mode on the CPU), written to an .npz for the port's gradient tests.

    XLA_FLAGS=--xla_cpu_max_isa=SSE4_2 python tests/_jax_grad_ref.py IN.npz OUT.npz JOBS.json

Each job of JOBS.json names a kernel (``k2``
``render_pass_megakernel_jvp``, ``k3`` ``material_grads``, ``k4``
``geometry_grads``, ``loss`` the cross-estimator loss of an engine ``mega``
step and its material gradients, with ``geometry`` its sphere gradients
too, ``render_loss`` the budget engine's ``diff/inverse.py:render_loss`` and
its gradient with respect to the scene fields ``params``), a scene
(``tests/torch_port.py:jax_grad_scene``), the image size, the RenderConfig
fields and a PRNG key; k2 its tangents (entries of scene fields set to 1),
k3/k4 a cotangent and ``loss`` a target (arrays of IN.npz); k4 may set
``track_slots``, the kernel's slot count (TRACK_SLOTS) for that job. The
outputs go to OUT.npz under ``<job name>/<field>``, with ``<job name>/seed``
the u32 seed the port must take for the same stream.

Every packed scene the kernels see is the port's (IN.npz
``packed/<scene>``), with the tangents of JAX's own packing: the two
packages' float32 inverses (LAPACK builds) differ in last bits, and a path
through caustics' glass ball amplifies such bits (ROADMAP Queue 3). With
the same packed scene and XLA's multiply-add fusion off (SSE4.2: every
product rounded, as in PyTorch) the two packages are held to the same
arithmetic.
"""

import json
import os
import sys

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_port import jax_grad_scene  # noqa: E402

from kajo_tpu.diff.inverse import extract_params, render_loss  # noqa: E402
from kajo_tpu.models.integrator import RenderConfig  # noqa: E402
from kajo_tpu.ops.pallas import megakernel, megakernel_geom, megakernel_grad  # noqa: E402
from kajo_tpu.ops.rng import seed_from_key  # noqa: E402

_own_pack = megakernel._pack_scene
_TRACK_SLOTS = megakernel_geom.TRACK_SLOTS


def use_packed(port_packed):
    """Make every kernel see ``port_packed`` with the tangent of JAX's own
    packing: value p + (x - x) is p exactly, its tangent is x's. The jitted
    kernels bake the array in when they trace, so their caches are cleared:
    a later scene of the same shapes must not reuse it."""

    def pack(prep):
        x = _own_pack(prep)
        return jnp.asarray(port_packed)[None, :] + (x - jax.lax.stop_gradient(x))

    for mod in (megakernel, megakernel_grad, megakernel_geom):
        mod._pack_scene = pack
    jax.clear_caches()


def tangent_of(scene, entries):
    tan = megakernel.scene_zero_tangent(scene)
    for path, index in entries:
        *outer, name = path.split(".")
        holder = tan
        for o in outer:
            holder = getattr(holder, o)
        arr = getattr(holder, name).at[tuple(index)].set(1.0)
        if outer:
            tan = dataclasses.replace(tan, **{outer[0]: dataclasses.replace(holder, **{name: arr})})
        else:
            tan = dataclasses.replace(tan, **{name: arr})
    return tan


def cross_loss_grads(scene, key, target, clip, w, h, spp, cfg, name, geometry=False):
    """What one step of ``InverseRenderer(engine="mega")`` differentiates,
    composed from the kernels rather than its jitted step: the key splits
    into k1, k2 (``diff/inverse.py:211``); the renders of k1 and k2 give the
    cross-estimator loss mean((i1 - t)(i2 - t)) of :207-223; its cotangents
    go through ``material_grads``, and with ``geometry`` through
    ``geometry_grads`` too, with the render's own key, as the
    ``make_diff_renderer`` VJP does."""
    k1, k2 = jax.random.split(key)
    i1, i2 = (megakernel.render_pass_megakernel(scene, k, w, h, spp, cfg)[..., :3] for k in (k1, k2))
    t = jnp.asarray(target)[..., :3]

    def loss(a, b):
        tt = t
        if clip is not None:
            tt, a, b = jnp.clip(tt, 0.0, clip), jnp.clip(a, 0.0, clip), jnp.clip(b, 0.0, clip)
        return jnp.mean((a - tt) * (b - tt))

    value, vjp = jax.vjp(loss, i1, i2)
    g1, g2 = vjp(jnp.float32(1.0))
    gr1 = megakernel_grad.material_grads(scene, k1, g1, w, h, spp, cfg)
    gr2 = megakernel_grad.material_grads(scene, k2, g2, w, h, spp, cfg)
    out = {f"{name}/{k}": np.asarray(gr1[k] + gr2[k]) for k in gr1}
    if geometry:
        gg1 = megakernel_geom.geometry_grads(scene, k1, g1, w, h, spp, cfg)
        gg2 = megakernel_geom.geometry_grads(scene, k2, g2, w, h, spp, cfg)
        out.update({f"{name}/{k}": np.asarray(gg1[k] + gg2[k]) for k in gg1})
    out[f"{name}/loss"] = np.asarray(value)
    out[f"{name}/seeds"] = np.array([seed_from_key(k1), seed_from_key(k2)], np.uint32)
    return out


def main(inp, out, jobs_path):
    arrays = dict(np.load(inp))
    jobs = json.load(open(jobs_path))
    result = {}
    for job in jobs:
        w, h, spp = job["w"], job["h"], job["spp"]
        scene = jax.tree.map(jnp.asarray, jax_grad_scene(job["scene"], w / h))
        use_packed(arrays[f"packed/{job['scene']}"])  # clears the jit caches
        # K4's slot count is read when its kernel is traced
        megakernel_geom.TRACK_SLOTS = job.get("track_slots", _TRACK_SLOTS)
        cfg = RenderConfig(**job.get("config", {}))
        key = jax.random.PRNGKey(job["key"])
        name = job["name"]
        result[f"{name}/seed"] = np.uint32(seed_from_key(key))
        with pltpu.force_tpu_interpret_mode():
            if job["kind"] == "render_loss":
                value, grads = jax.value_and_grad(
                    lambda p: render_loss(p, scene, arrays[job["target"]], key, w, h, spp, cfg,
                                          loss_clip=job.get("loss_clip"))
                )(extract_params(scene, tuple(job["params"])))
                result[f"{name}/loss"] = np.asarray(value)
                result.update({f"{name}/{k}": np.asarray(v) for k, v in grads.items()})
                result[f"{name}/seeds"] = np.array([seed_from_key(k) for k in jax.random.split(key)], np.uint32)
            elif job["kind"] == "loss":
                result.update(cross_loss_grads(scene, key, arrays[job["target"]], job.get("loss_clip"), w, h, spp, cfg,
                                               name, job.get("geometry", False)))
            elif job["kind"] == "k2":
                for t, entries in job["tangents"].items():
                    _, img_dot = megakernel.render_pass_megakernel_jvp(
                        scene, tangent_of(scene, entries), key, w, h, spp, cfg
                    )
                    result[f"{name}/{t}"] = np.asarray(img_dot)
            else:
                fn = megakernel_grad.material_grads if job["kind"] == "k3" else megakernel_geom.geometry_grads
                gr = fn(scene, key, arrays[job["cotangent"]], w, h, spp, cfg)
                result.update({f"{name}/{k}": np.asarray(v) for k, v in gr.items()})
        print(f"{name} done", flush=True)
    np.savez(out, **result)


if __name__ == "__main__":
    main(*sys.argv[1:4])
