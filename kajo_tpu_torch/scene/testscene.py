"""Built-in fallback test scene (port of ``kajo_tpu/scene/testscene.py``).

The scene the CLI renders when it gets no scene file: four unit spheres (one
refractive, one Phong), one small emissive sphere, a ground plane, four walls
and a ceiling, perspective camera. Colors are already linear. Beside it the
scenes of the tests and the chip run: two lights (one-light NEE), a cluster
of mirrors, and the boundary terms' probes (``build_silhouette_scene``, a
flat-lit sphere; ``build_shadow_scene``, an occluder seen only through its
shadow). Every scene function puts the scene on ``device``, by default the
CUDA device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import math3d
from .types import Camera, Scene, make_scene


def build_test_scene(aspect_ratio: float = 4.0 / 3.0, device="cuda") -> Scene:
    colors = np.array(
        [[1, 1, 1, 1], [0.8, 0.1, 0.1, 1], [0.1, 0.8, 0.1, 1], [0.1, 0.1, 0.8, 1]],
        np.float32,
    )

    spheres = []
    for i in range(4):
        material = {"ambient": colors[i] * 0.1, "diffuse": colors[i]}
        if i == 1:
            material["specular_exponent"] = 20.0
        if i == 0:
            material["transparency"] = np.full(4, 0.9, np.float32)
            material["refractive_index"] = 1.5
        spheres.append(
            {
                "transform": math3d.translate(math3d.identity(), [i * 3 - 2, 0, i * 0.5]),
                "radius": 1.0,
                "material": material,
            }
        )
    spheres.append(
        {
            "transform": math3d.translate(math3d.identity(), [0, -1.5, 2]),
            "radius": 0.3,
            "material": {"emission": np.array([8, 8, 8, 0], np.float32)},
        }
    )

    gray = {"diffuse": np.array([0.4, 0.4, 0.4, 1], np.float32)}
    white = {"diffuse": np.array([1, 1, 1, 1], np.float32)}
    ident = math3d.identity()
    planes = [
        {"transform": math3d.translate(ident, [0, 1, 0]), "material": gray},
        {"transform": math3d.translate(math3d.rotate(ident, -90, [1, 0, 0]), [0, 2, 0]), "material": white},
        {"transform": math3d.translate(math3d.rotate(ident, -90, [0, 0, 1]), [0, 10, 0]), "material": white},
        {"transform": math3d.translate(math3d.rotate(ident, 90, [0, 0, 1]), [0, 8, 0]), "material": white},
        {"transform": math3d.translate(math3d.rotate(ident, 90, [1, 0, 0]), [0, 6, 0]), "material": white},
        {"transform": math3d.translate(math3d.rotate(ident, 180, [1, 0, 0]), [0, 2, 0]), "material": white},
    ]

    camera = Camera(
        transform=torch.tensor(math3d.look_at([-6, -0.8, 4], [0, 0, 0], [0, -1, 0])),
        projection=torch.tensor(math3d.perspective(45.0, aspect_ratio, 0.1, 100.0)),
    )
    return make_scene(camera, np.array([0, 0, 0, 1], np.float32), planes, spheres, device)


def two_light_scene_parts(aspect_ratio: float = 1.5):
    """(camera transform, camera projection, background, planes, spheres) of
    a small two-light scene, as numpy data for either package's
    ``make_scene``.

    Two planes, a diffuse and a Phong sphere, and two emissive spheres that
    also reflect diffusely, so that one-light NEE, the throughput cull
    (``regen_threshold``) and full MIS each change the image at a few
    samples per pixel."""
    ident = math3d.identity()
    planes = [
        {"transform": math3d.translate(ident, [0, 1, 0]), "material": {"diffuse": [0.5, 0.5, 0.5, 1]}},
        {
            "transform": math3d.translate(math3d.rotate(ident, -90, [1, 0, 0]), [0, 4, 0]),
            "material": {"diffuse": [0.4, 0.5, 0.6, 1]},
        },
    ]
    spheres = [
        {"transform": math3d.translate(ident, [-1.2, 0, 0]), "radius": 1.0,
         "material": {"diffuse": [0.7, 0.3, 0.2, 1]}},
        {"transform": math3d.translate(ident, [1.2, 0, 0.3]), "radius": 0.9,
         "material": {"specular": [0.8, 0.8, 0.8, 1], "specular_exponent": 40.0}},
        {"transform": math3d.translate(ident, [-0.5, -2.0, 1.5]), "radius": 0.35,
         "material": {"emission": [6, 6, 5, 1], "diffuse": [0.5, 0.5, 0.5, 1]}},
        {"transform": math3d.translate(ident, [1.5, -1.8, 2.0]), "radius": 0.25,
         "material": {"emission": [3, 2, 1, 1], "diffuse": [0.3, 0.3, 0.3, 1]}},
    ]
    view = math3d.look_at([0, -1.5, 6], [0, 0, 0], [0, -1, 0])
    projection = math3d.perspective(50.0, aspect_ratio, 0.1, 100.0)
    return view, projection, np.zeros(4, np.float32), planes, spheres


def build_two_light_scene(aspect_ratio: float = 1.5, device="cuda") -> Scene:
    view, projection, background, planes, spheres = two_light_scene_parts(aspect_ratio)
    camera = Camera(transform=torch.tensor(view), projection=torch.tensor(projection))
    return make_scene(camera, background, planes, spheres, device)


def mirror_cluster_parts(aspect_ratio: float = 4.0 / 3.0):
    """(camera transform, camera projection, background, planes, spheres) of
    27 mirror spheres packed in a 3 x 3 x 3 block over a ground plane, lit
    by one emissive sphere above, as numpy data for either package's
    ``make_scene``: paths bounce between many spheres, so at a large
    ``max_depth`` some visit more than the geometry kernel's
    ``TRACK_SLOTS`` distinct spheres in one sample."""
    ident = math3d.identity()
    spheres = [
        {
            "transform": math3d.translate(ident, [1.05 * (i - 1), 1.05 * (j - 1) - 1.0, 1.05 * (k - 1)]),
            "radius": 0.5,
            "material": {"specular": [0.95, 0.9, 0.85, 1]},
        }
        for i in range(3)
        for j in range(3)
        for k in range(3)
    ]
    spheres.append(
        {
            "transform": math3d.translate(ident, [0.0, -4.0, 0.0]),
            "radius": 0.6,
            "material": {"emission": [10, 10, 10, 1]},
        }
    )
    planes = [{"transform": math3d.translate(ident, [0, 1, 0]), "material": {"diffuse": [0.5, 0.5, 0.5, 1]}}]
    view = math3d.look_at([0.3, -1.2, 4.5], [0, -1, 0], [0, -1, 0])
    projection = math3d.perspective(30.0, aspect_ratio, 0.1, 100.0)
    return view, projection, np.zeros(4, np.float32), planes, spheres


def build_mirror_cluster(aspect_ratio: float = 4.0 / 3.0, device="cuda") -> Scene:
    """The scene of :func:`mirror_cluster_parts`."""
    view, projection, background, planes, spheres = mirror_cluster_parts(aspect_ratio)
    camera = Camera(transform=torch.tensor(view), projection=torch.tensor(projection))
    return make_scene(camera, background, planes, spheres, device)


def build_silhouette_scene(cx: float = 0.0, cy: float = 0.0, background=(0.3, 0.3, 0.3, 1.0), device="cuda") -> Scene:
    """A self-luminous unit sphere at (cx, cy, 0) seen from z = -5 on a
    uniform background: its position reaches the image only through its
    silhouette (``tests/test_edges.py``'s ``_edge_scene``)."""
    camera = Camera(
        transform=math3d.look_at([0, 0, -5], [0, 0, 0], [0, -1, 0]),
        projection=math3d.perspective(45.0, 1.0, 0.1, 100.0),
    )
    spheres = [{
        "transform": math3d.translate(math3d.identity(), [cx, cy, 0.0]),
        "radius": 1.0,
        "material": {"emission": np.array([2.0, 2.0, 2.0, 0.0], np.float32)},
    }]
    return make_scene(camera, np.array(background, np.float32), [], spheres, device)


def build_shadow_scene(ox: float = 2.0, device="cuda") -> Scene:
    """An absorbing sphere at (ox, -1, 0), out of the frame, casting a shadow
    on a floor from a light high above: it reaches the image only through
    NEE visibility (``tests/test_edges.py``'s ``_shadow_scene``)."""
    camera = Camera(
        transform=math3d.look_at([3.0, -2.0, 0.0], [3.0, 1.0, 0.0], [0, 0, 1]),
        projection=math3d.perspective(30.0, 1.0, 0.1, 100.0),
    )
    planes = [{
        "transform": math3d.translate(math3d.identity(), [0.0, 1.0, 0.0]),
        "material": {"diffuse": np.array([0.8, 0.8, 0.8, 1.0], np.float32)},
    }]
    spheres = [
        {"transform": math3d.translate(math3d.identity(), [ox, -1.0, 0.0]), "radius": 0.4, "material": {}},
        {
            "transform": math3d.translate(math3d.identity(), [0.0, -5.0, 0.0]),
            "radius": 0.5,
            "material": {"emission": np.array([30.0, 30.0, 30.0, 0.0], np.float32)},
        },
    ]
    return make_scene(camera, np.array([0.0, 0.0, 0.0, 1.0], np.float32), planes, spheres, device)
