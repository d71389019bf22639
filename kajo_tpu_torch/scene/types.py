"""Scene data model: structure-of-arrays tensors over analytic primitives.

Port of ``kajo_tpu/scene/types.py``. The same fields, in the same order:

  * object ids are dense indices, **planes first then spheres**, matching the
    reference nearest-hit scan order;
  * material fields are per-object tensors;
  * the set of emissive spheres (the lights) is static structure captured at
    construction (``light_indices``); ``rigid_spheres`` records whether every
    sphere transform is rigid, which selects the packed sphere record.

Every tensor of a scene lives on one device, ``Scene.device``, given when the
scene is built. Construction happens on the host in numpy (as in the
JAX package) and ends in :func:`scene_from_numpy`, which is also the bridge
the tests use to hand one scene to both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Materials:
    """Per-object material table, planes first then spheres.

    Defaults per the reference: colors zero, specular_exponent 0,
    refractive_index 1."""

    ambient: torch.Tensor            # [K, 4] (parsed but unused by shading)
    diffuse: torch.Tensor            # [K, 4]
    specular: torch.Tensor           # [K, 4]
    emission: torch.Tensor           # [K, 4]
    transparency: torch.Tensor       # [K, 4]
    specular_exponent: torch.Tensor  # [K]
    refractive_index: torch.Tensor   # [K]


@dataclasses.dataclass(frozen=True)
class Camera:
    transform: torch.Tensor   # [4, 4] view matrix
    projection: torch.Tensor  # [4, 4]

    @staticmethod
    def default() -> "Camera":
        return Camera(torch.eye(4), torch.eye(4))


@dataclasses.dataclass(frozen=True)
class Scene:
    """A scene on one device. ``light_indices`` index the sphere arrays of
    the spheres that had nonzero emission at load time (planes never act as
    lights)."""

    camera: Camera
    background: torch.Tensor        # [4]
    plane_transform: torch.Tensor   # [P, 4, 4]
    sphere_transform: torch.Tensor  # [S, 4, 4]
    sphere_radius: torch.Tensor     # [S]
    materials: Materials            # K = P + S entries, planes first
    light_indices: Tuple[int, ...]
    # True when every sphere transform is rigid (orthonormal linear part,
    # det +1): the kernels then use the 4-float world-space sphere record
    rigid_spheres: bool = False

    @property
    def device(self) -> torch.device:
        return self.background.device

    @property
    def num_planes(self) -> int:
        return self.plane_transform.shape[0]

    @property
    def num_spheres(self) -> int:
        return self.sphere_transform.shape[0]

    @property
    def num_objects(self) -> int:
        return self.num_planes + self.num_spheres

    @property
    def num_lights(self) -> int:
        return len(self.light_indices)


def map_tensors(fn, scene: Scene, *others: Scene) -> Scene:
    """The scene whose every tensor is ``fn`` of the scene's tensor (and of
    the same tensor of each of ``others``); the static fields are the
    scene's."""

    def go(a, *bs):
        if isinstance(a, torch.Tensor):
            return fn(a, *bs)
        if dataclasses.is_dataclass(a):
            return dataclasses.replace(
                a, **{f.name: go(getattr(a, f.name), *(getattr(b, f.name) for b in bs)) for f in dataclasses.fields(a)}
            )
        return a

    return go(scene, *others)


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32), device=device)


def check_device(device) -> torch.device:
    """``device`` as a torch.device; raises when it is CUDA and PyTorch sees
    no CUDA device (the loaders default to ``"cuda"`` and never fall back
    to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the scene goes to a CUDA device by default, but PyTorch sees none; "
            "pass device='cpu' to build it on the CPU"
        )
    return device


def scene_from_numpy(leaves: Mapping[str, Any], device="cuda") -> Scene:
    """Build a :class:`Scene` on ``device`` (default: the CUDA device) from
    host arrays.

    ``leaves`` is a nested mapping with the field names of
    ``kajo_tpu.scene.types.Scene`` (the shape ``dataclasses.asdict`` gives
    for a scene of either package): ``camera`` {transform, projection},
    ``background``, ``plane_transform``, ``sphere_transform``,
    ``sphere_radius``, ``materials`` {the seven material fields},
    ``light_indices`` and ``rigid_spheres``. Array leaves may be numpy
    arrays or anything ``np.asarray`` accepts."""
    device = check_device(device)
    cam = leaves["camera"]
    mats = leaves["materials"]
    return Scene(
        camera=Camera(_f32(cam["transform"], device), _f32(cam["projection"], device)),
        background=_f32(leaves["background"], device),
        plane_transform=_f32(leaves["plane_transform"], device).reshape(-1, 4, 4),
        sphere_transform=_f32(leaves["sphere_transform"], device).reshape(-1, 4, 4),
        sphere_radius=_f32(leaves["sphere_radius"], device).reshape(-1),
        materials=Materials(
            **{f.name: _f32(mats[f.name], device) for f in dataclasses.fields(Materials)}
        ),
        light_indices=tuple(int(i) for i in leaves["light_indices"]),
        rigid_spheres=bool(leaves.get("rigid_spheres", False)),
    )


def make_scene(camera, background, planes, spheres, device="cuda") -> Scene:
    """Assemble a Scene from per-object dicts (host-side), as
    ``kajo_tpu.scene.types.make_scene`` does.

    ``camera``: anything with ``transform`` and ``projection`` [4, 4] arrays.
    ``planes``: list of dicts {"transform": (4,4), "material": dict}
    ``spheres``: list of dicts {"transform": (4,4), "radius": float, "material": dict}
    Material dict keys: ambient/diffuse/specular/emission/transparency
    (vec4-like), specular_exponent, refractive_index. The scene goes to
    ``device``, by default the CUDA device (see :func:`check_device`).
    """
    check_device(device)
    p, s = len(planes), len(spheres)
    z4 = np.zeros((p + s, 4), np.float32)
    mat_arrays = {
        "ambient": z4.copy(),
        "diffuse": z4.copy(),
        "specular": z4.copy(),
        "emission": z4.copy(),
        "transparency": z4.copy(),
        "specular_exponent": np.zeros((p + s,), np.float32),
        "refractive_index": np.ones((p + s,), np.float32),
    }

    def fill(i, material):
        for key, arr in mat_arrays.items():
            if key in material:
                arr[i] = np.asarray(material[key], np.float32)

    plane_t = np.tile(np.eye(4, dtype=np.float32), (max(p, 1), 1, 1))[:p]
    for i, obj in enumerate(planes):
        plane_t[i] = np.asarray(obj["transform"], np.float32)
        fill(i, obj.get("material", {}))

    sphere_t = np.tile(np.eye(4, dtype=np.float32), (max(s, 1), 1, 1))[:s]
    sphere_r = np.zeros((s,), np.float32)
    for i, obj in enumerate(spheres):
        sphere_t[i] = np.asarray(obj["transform"], np.float32)
        sphere_r[i] = np.float32(obj["radius"])
        fill(p + i, obj.get("material", {}))

    emission = mat_arrays["emission"][p:]
    light_indices = tuple(int(i) for i in range(s) if np.any(emission[i] != 0.0))

    linear = sphere_t[:, :3, :3]
    rigid = bool(
        s == 0
        or (
            np.allclose(
                np.einsum("sij,skj->sik", linear, linear),
                np.eye(3, dtype=np.float32)[None],
                atol=1e-5,
            )
            and np.allclose(np.linalg.det(linear), 1.0, atol=1e-5)
        )
    )

    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else x

    return scene_from_numpy(
        dict(
            camera=dict(transform=host(camera.transform), projection=host(camera.projection)),
            background=host(background),
            plane_transform=plane_t,
            sphere_transform=sphere_t,
            sphere_radius=sphere_r,
            materials=mat_arrays,
            light_indices=light_indices,
            rigid_spheres=rigid,
        ),
        device,
    )
