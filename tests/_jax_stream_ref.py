"""Reference outputs of the JAX package's V4 streaming kernels (Pallas
interpret mode on the CPU), written to an .npz for the port's tests.

    XLA_FLAGS=--xla_cpu_max_isa=SSE4_2 python tests/_jax_stream_ref.py OUT.npz {rigid|jitter}

The port's plain versions compute every float in its own rounding step. The
XLA CPU compiler contracts a*b + c into one fused multiply-add where the
instruction set has one, which changes last bits; capping the instruction
set at SSE4.2 (no FMA) keeps every product rounded, so the two packages can
be held to bit equality. The tests run this script in a subprocess with that
flag, since the flag must be set before the XLA backend starts.

The scene is ``random_spheres_scene(1500, seed=4, extent=20)``, rigid or
with ``scale_jitter=0.6``; the rays are 32 x 24 primary rays and as many
scattered rays (origins in the field, random directions), made with numpy
from a seed.
"""

import sys

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from kajo_tpu.ops import geometry  # noqa: E402
from kajo_tpu.ops.pallas import stream_trace as st  # noqa: E402
from kajo_tpu.scene.procedural import random_spheres_scene  # noqa: E402

N_SPHERES, SCENE_SEED, EXTENT = 1500, 4, 20.0


def rays(prep, seed=7):
    """32 x 24 primary rays, then as many scattered ones -> (o, d) f32 [N, 3]."""
    xs, ys = np.meshgrid(np.linspace(0.02, 0.98, 32), np.linspace(0.02, 0.98, 24))
    o_pri, d_pri = geometry.generate_rays(
        prep.camera, jnp.asarray(xs.ravel(), jnp.float32), jnp.asarray(ys.ravel(), jnp.float32)
    )
    rng = np.random.default_rng(seed)
    m = o_pri.shape[0]
    o_sc = rng.uniform(-EXTENT, EXTENT, (m, 3)).astype(np.float32)
    o_sc[:, 1] = rng.uniform(-2.0, 0.99, m).astype(np.float32)  # above the y = 1 ground
    d_sc = rng.normal(size=(m, 3)).astype(np.float32)
    d_sc /= np.linalg.norm(d_sc, axis=1, keepdims=True)
    o = np.concatenate([np.asarray(o_pri), o_sc]).astype(np.float32)
    d = np.concatenate([np.asarray(d_pri), d_sc]).astype(np.float32)
    return o, d


def main(out, case):
    scene = random_spheres_scene(N_SPHERES, seed=SCENE_SEED, extent=EXTENT, scale_jitter=0.6 if case == "jitter" else 0.0)
    geometry.FORCE_STREAM = True
    prep = geometry.prepare_scene(scene)
    o, d = rays(prep)
    n = o.shape[0]
    rng = np.random.default_rng(11)
    # half the rays unbounded, half with a bound inside the field
    t_max = np.where(rng.uniform(size=n) < 0.5, np.inf, rng.uniform(2.0, 40.0, n)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        t_near, idx_near = st.nearest_sphere(prep, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
        perm = np.asarray(prep.stream_perm)
        packed = np.asarray(prep.stream_packed)
        idx_near = np.asarray(idx_near)
        # the packed row of each winner: half the occlusion rays exclude it
        inv_perm = np.zeros(N_SPHERES + 4, np.int32)
        real = packed[:, 3 if case == "rigid" else 12] >= 0.0
        inv_perm[perm[real]] = np.nonzero(real)[0]
        excl = np.where((idx_near >= 0) & (rng.uniform(size=n) < 0.5), inv_perm[np.maximum(idx_near, 0)], -1)
        t_cut = rng.uniform(0.0, 40.0, n).astype(np.float32)
        t_cut[rng.uniform(size=n) < 0.1] = 0.0
        occluded = st.occluded_sphere(prep, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_cut),
                                      jnp.asarray(excl.astype(np.int32)))
    np.savez(
        out,
        o=o, d=d, t_max=t_max, t_cut=t_cut, excl=excl.astype(np.int32),
        t_near=np.asarray(t_near), idx_near=idx_near, occluded=np.asarray(occluded),
        packed=packed, boxes=np.asarray(prep.stream_boxes)[:, 0, :], perm=perm,
        morton=np.asarray(st.morton_order(prep.sphere_center)),
        sphere_inv3=np.asarray(prep.sphere_inv3), sphere_invt=np.asarray(prep.sphere_invt),
        sphere_det=np.asarray(prep.sphere_det), camera_origin=np.asarray(prep.camera.origin),
    )


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
