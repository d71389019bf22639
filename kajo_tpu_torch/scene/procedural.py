"""Procedural big scene: the 100k-sphere scaling configuration (port of
``kajo_tpu/scene/procedural.py``).

A field of small spheres on a ground plane with a few emissive spheres,
built on the host in numpy from ``seed`` with the same generator calls in
the same order as the JAX package, so both packages build the same arrays.
"""

from __future__ import annotations

import numpy as np

from ..utils import math3d
from .types import Camera, Scene, make_scene


def random_spheres_scene(
    n_spheres: int,
    seed: int = 0,
    extent: float = 60.0,
    n_lights: int = 4,
    aspect_ratio: float = 4.0 / 3.0,
    scale_jitter: float = 0.0,
    device="cuda",
) -> Scene:
    """``n_spheres`` diffuse or Phong spheres (radius 0.1-0.45) scattered over
    [-extent, extent]² on the y = 1 ground plane, ``n_lights`` emissive
    spheres above them, the camera looking across the field; on ``device``.

    ``scale_jitter`` > 0 makes the scene non-rigid: each sphere's transform
    gains a rotation and a uniform scale in [1/(1+j), 1+j], its radius
    divided by the scale so the world silhouette stays comparable. That
    takes the general (object-space, det-scaled t) record."""
    rng = np.random.default_rng(seed)
    ident = math3d.identity()

    pos = np.empty((n_spheres, 3), np.float32)
    pos[:, 0] = rng.uniform(-extent, extent, n_spheres)
    pos[:, 2] = rng.uniform(-extent, extent, n_spheres)
    radii = rng.uniform(0.1, 0.45, n_spheres).astype(np.float32)
    pos[:, 1] = 1.0 - radii  # resting on the y=1 ground plane (y points down)
    hues = rng.uniform(0.2, 1.0, (n_spheres, 3)).astype(np.float32)
    shiny = rng.uniform(0, 1, n_spheres) < 0.2

    if scale_jitter > 0.0:
        scales = np.exp(rng.uniform(-np.log1p(scale_jitter), np.log1p(scale_jitter), n_spheres)).astype(np.float32)
        angles = rng.uniform(0.0, 360.0, n_spheres).astype(np.float32)
        axes = rng.normal(size=(n_spheres, 3)).astype(np.float32)

    spheres = []
    for i in range(n_spheres):
        material = {"diffuse": np.append(hues[i], 1.0)}
        if shiny[i]:
            material = {"specular": np.append(hues[i], 1.0), "specular_exponent": float(rng.integers(20, 200))}
        transform = math3d.translate(ident, pos[i])
        radius = float(radii[i])
        if scale_jitter > 0.0:
            s = float(scales[i])
            transform = math3d.rotate(transform, float(angles[i]), axes[i]) @ np.diag([s, s, s, 1.0]).astype(np.float32)
            radius /= s  # world silhouette stays ~radii[i]
        spheres.append({"transform": transform, "radius": radius, "material": material})

    for i in range(n_lights):
        ang = 2 * np.pi * i / max(n_lights, 1)
        spheres.append(
            {
                "transform": math3d.translate(ident, [0.5 * extent * np.cos(ang), -8.0, 0.5 * extent * np.sin(ang)]),
                "radius": 1.5,
                "material": {"emission": np.array([60, 60, 60, 0], np.float32)},
            }
        )

    planes = [
        {
            "transform": math3d.translate(ident, [0, 1, 0]),
            "material": {"diffuse": np.array([0.5, 0.5, 0.5, 1], np.float32)},
        }
    ]
    camera = Camera(
        transform=math3d.look_at([-0.8 * extent, -6.0, -0.8 * extent], [0, 0, 0], [0, -1, 0]),
        projection=math3d.perspective(55.0, aspect_ratio, 0.1, 10.0 * extent),
    )
    return make_scene(camera, np.array([0.01, 0.01, 0.02, 1], np.float32), planes, spheres, device)
