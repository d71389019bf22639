"""The scene file, parsed and prepared for the lane loop.

:func:`load_packed` reads a kajo scene file (tolerant JSON, the colour and
transform mini-languages, the camera's ``perspective``) on the host in
numpy, moves its arrays to a device, and prepares them there as K1's packed
scene: plane rows of the inverse transforms and their determinants, sphere
centres (rigid scenes) or inverse and forward transforms (general ones),
the light table, the background and the camera's image-plane basis, in one
float32 vector of the layout planes | spheres | materials | lights |
background | camera.

The matrix work uses GLM 0.9.3's conventions (degrees; ``result @ X``
composition; OpenGL ``lookAt`` and symmetric ``perspective``) with the same
float32 operations in the same order as the port, so that on one device
the two pack the same bits.
"""

from __future__ import annotations

import dataclasses
import json
import re

import numpy as np
import torch

PLANE_FLOATS = 8  # inverse transform's row 1 (4), det, normal (3)
RIGID_FLOATS = 4  # centre (3), r²
GENERAL_FLOATS = 23  # inverse 3x3 (9), inverse translation (3), r², det, forward 3x3 (9)
MATERIAL_FLOATS = 14  # diffuse, specular, emission, transparency (3 each), exponent, IOR
LIGHT_FLOATS = 8  # centre (3), radius, emission (3), object id

_TRAILING_COMMA = re.compile(r",(\s*[}\]])")
_BARE_DECIMAL = re.compile(r"(?<=[:\[,\s])(-?)\.(\d)")
_CALL = re.compile(r"([A-Za-z_]+)\s*\(([^)]*)\)")
_NUMBER = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")
_MATERIAL_KEYS = ("diffuse", "specular", "emission", "transparency")


def _numbers(text: str) -> list:
    return [float(m.group(0)) for m in _NUMBER.finditer(text)]


def parse_color(value: str) -> np.ndarray:
    """``#rgb``, ``#rrggbb``, ``rgb(...)``, ``rgba(...)`` -> linear RGBA:
    every component, alpha too, raised to 2.2, unclamped."""
    value = value.strip()
    out = np.zeros(4, np.float32)
    if len(value) == 4 and value[0] == "#":
        out[:3] = [int(c, 16) / 15.0 for c in value[1:4]]
        out[3] = 1.0
    elif len(value) == 7 and value[0] == "#":
        out[:3] = [int(value[i : i + 2], 16) / 255.0 for i in (1, 3, 5)]
        out[3] = 1.0
    elif value.startswith("rgba("):
        out[:] = (_numbers(value[5:]) + [0.0] * 4)[:4]
    elif value.startswith("rgb("):
        out[:3] = (_numbers(value[4:]) + [0.0] * 3)[:3]
        out[3] = 1.0
    return np.power(out, 2.2, dtype=np.float32)


def _translate(m, v):
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = np.asarray(v, dtype=np.float32)
    return (m @ t).astype(np.float32)


def _scale(m, v):
    s = np.eye(4, dtype=np.float32)
    v = np.asarray(v, dtype=np.float32)
    s[0, 0], s[1, 1], s[2, 2] = v[0], v[1], v[2]
    return (m @ s).astype(np.float32)


def _rotate(m, angle_deg, axis):
    a = np.deg2rad(np.asarray(angle_deg, dtype=np.float32))
    c, s = np.cos(a), np.sin(a)
    axis = np.asarray(axis, dtype=np.float32)
    axis = axis / np.linalg.norm(axis)
    x, y, z = axis[0], axis[1], axis[2]
    omc = 1.0 - c
    r = np.stack(
        [
            np.stack([c + omc * x * x, omc * x * y - s * z, omc * x * z + s * y]),
            np.stack([omc * y * x + s * z, c + omc * y * y, omc * y * z - s * x]),
            np.stack([omc * z * x - s * y, omc * z * y + s * x, c + omc * z * z]),
        ]
    )
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = r
    return (m @ out).astype(np.float32)


def _look_at(eye, center, up):
    eye, center, up = (np.asarray(v, dtype=np.float32) for v in (eye, center, up))
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.stack(
        [
            np.concatenate([s, np.reshape(-np.dot(s, eye), (1,))]),
            np.concatenate([u, np.reshape(-np.dot(u, eye), (1,))]),
            np.concatenate([-f, np.reshape(np.dot(f, eye), (1,))]),
            np.asarray([0.0, 0.0, 0.0, 1.0], dtype=np.float32),
        ]
    )
    return m.astype(np.float32)


def _perspective(fovy_deg, aspect, z_near, z_far):
    rng = np.tan(np.deg2rad(float(fovy_deg)) / 2.0) * float(z_near)
    left, right = -rng * float(aspect), rng * float(aspect)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = 2.0 * z_near / (right - left)
    m[1, 1] = 2.0 * z_near / (rng - -rng)
    m[2, 2] = -(z_far + z_near) / (z_far - z_near)
    m[2, 3] = -(2.0 * z_far * z_near) / (z_far - z_near)
    m[3, 2] = -1.0
    return m


def parse_transform(value: str) -> np.ndarray:
    """``lookat(9)``, ``translate(3)``, ``scale(3)``, ``rotate(deg, axis)``
    composed left to right; missing components are 0."""
    out = np.eye(4, dtype=np.float32)
    for m in _CALL.finditer(value):
        cmd, args = m.group(1), _numbers(m.group(2))
        if cmd == "lookat":
            args = (args + [0.0] * 9)[:9]
            out = out @ _look_at(args[0:3], args[3:6], args[6:9])
        elif cmd == "translate":
            out = _translate(out, (args + [0.0] * 3)[:3])
        elif cmd == "scale":
            out = _scale(out, (args + [0.0] * 3)[:3])
        elif cmd == "rotate":
            args = (args + [0.0] * 4)[:4]
            out = _rotate(out, args[0], args[1:4])
    return out.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class HostScene:
    """A parsed scene in host arrays; objects are planes first, then spheres."""

    view: np.ndarray  # [4, 4]
    projection: np.ndarray  # [4, 4]
    background: np.ndarray  # [4]
    plane_transform: np.ndarray  # [P, 4, 4]
    sphere_transform: np.ndarray  # [S, 4, 4]
    sphere_radius: np.ndarray  # [S]
    materials: dict  # name -> [P + S, 4] colours, [P + S] specular_exponent, refractive_index
    light_spheres: tuple  # sphere indices with a nonzero emission
    rigid: bool  # every sphere transform orthonormal with det +1


def parse(text: str, aspect_ratio: float) -> HostScene:
    data = json.loads(_BARE_DECIMAL.sub(r"\g<1>0.\g<2>", _TRAILING_COMMA.sub(r"\1", text)))
    view = np.eye(4, dtype=np.float32)
    projection = np.eye(4, dtype=np.float32)
    camera = data.get("camera", {})
    proj = camera.get("projection", "")
    if isinstance(proj, str) and proj.startswith("perspective("):
        fovy, near, far = (_numbers(proj[len("perspective(") :]) + [0.0] * 3)[:3]
        projection = _perspective(fovy, aspect_ratio, near, far)
    if "transform" in camera:
        view = parse_transform(camera["transform"])
    background = parse_color(data["background"]) if "background" in data else np.zeros(4, np.float32)

    planes, spheres = [], []
    for obj in data.get("objects", []):
        kind = obj.get("type")
        if kind not in ("plane", "sphere"):
            continue
        transform = parse_transform(obj["transform"]) if "transform" in obj else np.eye(4, dtype=np.float32)
        (planes if kind == "plane" else spheres).append((obj, transform))
    objects = planes + spheres
    k = len(objects)
    materials = {key: np.zeros((k, 4), np.float32) for key in _MATERIAL_KEYS}
    materials["specular_exponent"] = np.zeros((k,), np.float32)
    materials["refractive_index"] = np.ones((k,), np.float32)
    for i, (obj, _) in enumerate(objects):
        for key in _MATERIAL_KEYS:
            if key in obj:
                materials[key][i] = parse_color(obj[key])
        if "specularExponent" in obj:
            materials["specular_exponent"][i] = np.float32(obj["specularExponent"])
        if "refractiveIndex" in obj:
            materials["refractive_index"][i] = np.float32(obj["refractiveIndex"])

    def stack(items):
        return np.stack([t for _, t in items]).astype(np.float32) if items else np.zeros((0, 4, 4), np.float32)

    sphere_t = stack(spheres)
    emission = materials["emission"][len(planes) :]
    linear = sphere_t[:, :3, :3]
    rigid = bool(
        len(spheres) == 0
        or (
            np.allclose(np.einsum("sij,skj->sik", linear, linear), np.eye(3, dtype=np.float32)[None], atol=1e-5)
            and np.allclose(np.linalg.det(linear), 1.0, atol=1e-5)
        )
    )
    return HostScene(
        view=view,
        projection=projection,
        background=background,
        plane_transform=stack(planes),
        sphere_transform=sphere_t,
        sphere_radius=np.asarray([np.float32(o["radius"]) for o, _ in spheres], np.float32),
        materials=materials,
        light_spheres=tuple(i for i in range(len(spheres)) if np.any(emission[i] != 0.0)),
        rigid=rigid,
    )


@dataclasses.dataclass(frozen=True)
class PackedScene:
    """K1's packed scene vector on a device and its counts."""

    packed: torch.Tensor  # [F] float32
    n_planes: int
    n_spheres: int
    n_lights: int
    rigid: bool


def _unproject(win, inv):
    v = torch.cat([win * 2.0 - 1.0, win.new_ones(1)])
    out = inv @ v
    return out[:3] / out[3]


def pack(scene: HostScene, device) -> PackedScene:
    """Prepare ``scene`` on ``device`` and pack it (float32)."""

    def dev(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    pt = dev(scene.plane_transform).reshape(-1, 4, 4)
    st = dev(scene.sphere_transform).reshape(-1, 4, 4)
    radius = dev(scene.sphere_radius).reshape(-1)
    mats = {key: dev(v) for key, v in scene.materials.items()}
    p, s = pt.shape[0], st.shape[0]
    parts = []
    if p:
        inv = torch.linalg.inv(pt)
        parts.append(torch.cat([inv[:, 1, :], torch.linalg.det(pt)[:, None], -pt[:, :3, 1]], 1))
    if s and scene.rigid:
        parts.append(torch.cat([st[:, :3, 3], (radius * radius)[:, None]], 1))
    elif s:
        inv = torch.linalg.inv(st)
        parts.append(
            torch.cat(
                [
                    inv[:, :3, :3].reshape(s, 9),
                    inv[:, :3, 3],
                    (radius * radius)[:, None],
                    torch.linalg.det(st)[:, None],
                    st[:, :3, :3].reshape(s, 9),
                ],
                1,
            )
        )
    parts.append(
        torch.cat(
            [
                mats["diffuse"][:, :3],
                mats["specular"][:, :3],
                mats["emission"][:, :3],
                mats["transparency"][:, :3],
                mats["specular_exponent"][:, None],
                mats["refractive_index"][:, None],
            ],
            1,
        )
    )
    light_idx = torch.tensor(scene.light_spheres, dtype=torch.int64, device=device)
    if len(scene.light_spheres):
        parts.append(
            torch.cat(
                [
                    st[light_idx][:, :3, 3],
                    radius[light_idx][:, None],
                    mats["emission"][p + light_idx][:, :3],
                    (p + light_idx)[:, None].to(torch.float32),
                ],
                1,
            )
        )
    view, proj = dev(scene.view), dev(scene.projection)
    inv = torch.linalg.inv(proj @ view)
    corner = view.new_tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    p1, p2, p3 = (_unproject(c, inv) for c in corner)
    origin = (torch.linalg.inv(view) @ view.new_tensor([0.0, 0.0, 0.0, 1.0]))[:3]
    parts += [dev(scene.background)[:3], origin, p1, p2 - p1, p3 - p1]
    packed = torch.cat([x.reshape(-1).to(torch.float32) for x in parts]).contiguous()
    return PackedScene(packed, p, s, len(scene.light_spheres), scene.rigid)


def load_packed(path, aspect_ratio: float, device) -> PackedScene:
    with open(path) as f:
        return pack(parse(f.read(), aspect_ratio), device)
