"""Reference outputs of the JAX package's V1, V2 and V3 nearest-hit designs
(Pallas interpret mode on the CPU), written to an .npz for the port's tests.

    XLA_FLAGS=--xla_cpu_max_isa=SSE4_2 python tests/_jax_stream_designs_ref.py OUT.npz {rigid|jitter}

The scene and rays are those of ``tests/_jax_stream_ref.py`` (its docstring
says why XLA's instruction set is capped at SSE4.2):
``random_spheres_scene(1500, seed=4, extent=20)``, rigid or with
``scale_jitter=0.6``, 32 x 24 primary and as many scattered rays, half of
them with a bound in the field. ``stream_trace.nearest_sphere`` runs once
per flag set: V1 (``KERNEL_V4`` off), V1 with ``TILE_FRUSTUM`` and with
``NEAR_FAR_ORDER`` (rigid only), V2 (``KERNEL_V2``) and V3 (``KERNEL_V3``).
JAX's caches are cleared before each, and the kernel-building functions
each one reached are recorded, so a test can see that the flags took. Also
written:
``_frustum_candidates`` of the same rays at the V1 tile (4096 rays) and at
128-ray tiles; and V2 and V3 on one more call, ``stream_far_rays.far_rays``:
one 512-ray tile (V2's and V3's tile) of rays from 1e5-1e6 units out, where
the tile's vote, not each ray's box test, decides which blocks a ray scans.
"""

import sys

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
from _jax_stream_ref import EXTENT, N_SPHERES, SCENE_SEED, rays  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402
from stream_far_rays import far_rays  # noqa: E402

from kajo_tpu.ops import geometry  # noqa: E402
from kajo_tpu.ops.pallas import stream_trace as st  # noqa: E402
from kajo_tpu.scene.procedural import random_spheres_scene  # noqa: E402

FLAGS = ("KERNEL_V4", "KERNEL_V2", "KERNEL_V3", "TILE_FRUSTUM", "NEAR_FAR_ORDER")
DESIGNS = {  # the port's design name -> kajo_tpu's flags
    "v1": dict(KERNEL_V4=False),
    "v1-frustum": dict(KERNEL_V4=False, TILE_FRUSTUM=True),
    "v1-near-far": dict(KERNEL_V4=False, NEAR_FAR_ORDER=True),
    "v2": dict(KERNEL_V2=True),
    "v3": dict(KERNEL_V4=False, KERNEL_V3=True),
}
CASE_DESIGNS = {"rigid": tuple(DESIGNS), "jitter": ("v1", "v2", "v3")}
FAR_DESIGNS = ("v2", "v3")
KERNEL_FNS = ("_build_kernel", "_build_kernel_v2", "_build_kernel_v3", "_build_kernel_v4", "_frustum_candidates")


def main(out, case):
    jitter = 0.6 if case == "jitter" else 0.0
    scene = random_spheres_scene(N_SPHERES, seed=SCENE_SEED, extent=EXTENT, scale_jitter=jitter)
    geometry.FORCE_STREAM = True
    prep = geometry.prepare_scene(scene)
    o, d = rays(prep)
    n = o.shape[0]
    rng = np.random.default_rng(11)  # the bounds of tests/_jax_stream_ref.py
    t_max = np.where(rng.uniform(size=n) < 0.5, np.inf, rng.uniform(2.0, 40.0, n)).astype(np.float32)

    far = far_rays(EXTENT)
    reached = []
    for name in KERNEL_FNS:
        fn = getattr(st, name)
        setattr(st, name, lambda *a, _fn=fn, _name=name, **k: (reached.append(_name), _fn(*a, **k))[1])
    res = {}
    defaults = {f: getattr(st, f) for f in FLAGS}
    with pltpu.force_tpu_interpret_mode():
        for design in CASE_DESIGNS[case]:
            for f in FLAGS:
                setattr(st, f, DESIGNS[design].get(f, defaults[f]))
            jax.clear_caches()
            reached.clear()
            t, idx = st.nearest_sphere(prep, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
            res[f"t/{design}"] = np.asarray(t)
            res[f"idx/{design}"] = np.asarray(idx)
            res[f"reached/{design}"] = np.array(sorted(set(reached)))
            if design in FAR_DESIGNS:
                t, idx = st.nearest_sphere(prep, *(jnp.asarray(x) for x in far))
                res[f"far_t/{design}"] = np.asarray(t)
                res[f"far_idx/{design}"] = np.asarray(idx)
        # the frustum lists of the same rays, padded as nearest_sphere pads them
        tile = st.RAY_ROWS * 128
        n_pad = -(-n // tile) * tile
        o_p = jnp.pad(jnp.asarray(o), ((0, n_pad - n), (0, 0)))
        d_p = jnp.pad(jnp.asarray(d), ((0, n_pad - n), (0, 0)))
        tm = jnp.pad(jnp.minimum(jnp.asarray(t_max), st.BIG), (0, n_pad - n))
        b2 = prep.stream_boxes[:, 0, :]
        for rays_per_tile in (tile, 128):
            res[f"frustum/{rays_per_tile}"] = np.asarray(
                st._frustum_candidates(o_p, d_p, tm, b2, n_pad // rays_per_tile, rays_per_tile)
            )
    np.savez(
        out, o=o, d=d, t_max=t_max, far_o=far[0], far_d=far[1], far_t_max=far[2],
        packed=np.asarray(prep.stream_packed), boxes=np.asarray(b2), perm=np.asarray(prep.stream_perm), **res,
    )


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
