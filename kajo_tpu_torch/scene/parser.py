"""Kajo-compatible JSON scene loader.

Port of ``kajo_tpu/scene/parser.py`` (the reference scene DSL):

  * tolerant JSON: commas before ``}``/``]`` are stripped and leading-dot
    decimals (``.3``) get their zero;
  * color mini-DSL: ``#rgb``, ``#rrggbb``, ``rgb(r,g,b)``, ``rgba(r,g,b,a)``,
    converted sRGB->linear via ``pow(c, 2.2)`` applied to *all four*
    components and to unclamped values (``rgb(16,16,16)`` emission becomes
    ``16**2.2``);
  * transform mini-DSL composing ``lookat(9)``, ``translate(3)``,
    ``scale(3)``, ``rotate(angle_deg, axis)`` left to right by
    right-multiplication. Missing vector components are ZERO, not
    broadcast: ``scale(.5)`` means ``scale(.5, 0, 0)``;
  * camera ``perspective(fovy_deg, near, far)``: only the first three
    numbers are read, the aspect comes from the caller;
  * an objects array dispatching on ``"type": "sphere" | "plane"``.

The matrix math is the port's numpy copy of the JAX package's
(``kajo_tpu_torch.utils.math3d``). The scene goes to ``device``, by default
the CUDA device; without one the loaders raise unless given
``device="cpu"``.
"""

from __future__ import annotations

import json
import re

import numpy as np
import torch

from ..utils import math3d
from .types import Camera, Scene, check_device, make_scene

_TRAILING_COMMA = re.compile(r",(\s*[}\]])")
_BARE_DECIMAL = re.compile(r"(?<=[:\[,\s])(-?)\.(\d)")
_CALL = re.compile(r"([A-Za-z_]+)\s*\(([^)]*)\)")
_NUMBER = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")


def _loads_tolerant(text: str):
    text = _TRAILING_COMMA.sub(r"\1", text)
    text = _BARE_DECIMAL.sub(r"\g<1>0.\g<2>", text)
    return json.loads(text)


def _numbers(argstr: str):
    return [float(m.group(0)) for m in _NUMBER.finditer(argstr)]


def parse_color(value: str) -> np.ndarray:
    """Color DSL -> linear vec4."""
    value = value.strip()
    result = np.zeros(4, np.float32)
    if len(value) == 4 and value[0] == "#":
        result[:3] = [int(c, 16) / 15.0 for c in value[1:4]]
        result[3] = 1.0
    elif len(value) == 7 and value[0] == "#":
        result[:3] = [int(value[i : i + 2], 16) / 255.0 for i in (1, 3, 5)]
        result[3] = 1.0
    elif value.startswith("rgba("):
        result[:] = (_numbers(value[5:]) + [0.0] * 4)[:4]
    elif value.startswith("rgb("):
        result[:3] = (_numbers(value[4:]) + [0.0] * 3)[:3]
        result[3] = 1.0
    # sRGB -> linear, applied to all components and unclamped
    return np.power(result, 2.2, dtype=np.float32)


def parse_transform(value: str) -> np.ndarray:
    """Transform DSL -> mat4."""
    result = math3d.identity()
    for m in _CALL.finditer(value):
        cmd, args = m.group(1), _numbers(m.group(2))
        if cmd == "lookat":
            args = (args + [0.0] * 9)[:9]
            result = result @ math3d.look_at(args[0:3], args[3:6], args[6:9])
        elif cmd == "translate":
            result = math3d.translate(result, (args + [0.0] * 3)[:3])
        elif cmd == "scale":
            result = math3d.scale(result, (args + [0.0] * 3)[:3])
        elif cmd == "rotate":
            args = (args + [0.0] * 4)[:4]
            result = math3d.rotate(result, args[0], args[1:4])
    return result.astype(np.float32)


def parse_camera(data: dict, aspect_ratio: float) -> Camera:
    """Camera block; only the first three numbers of ``perspective(...)``
    are consumed."""
    projection = np.eye(4, dtype=np.float32)
    transform = np.eye(4, dtype=np.float32)
    proj = data.get("projection", "")
    if isinstance(proj, str) and proj.startswith("perspective("):
        nums = (_numbers(proj[len("perspective(") :]) + [0.0] * 3)[:3]
        projection = math3d.perspective(nums[0], aspect_ratio, nums[1], nums[2])
    if "transform" in data:
        transform = parse_transform(data["transform"])
    return Camera(transform=torch.tensor(transform), projection=torch.tensor(projection))


_MATERIAL_KEYS = {
    "ambient": parse_color,
    "diffuse": parse_color,
    "specular": parse_color,
    "emission": parse_color,
    "transparency": parse_color,
    "specularExponent": np.float32,
    "refractiveIndex": np.float32,
}
_MATERIAL_RENAME = {
    "specularExponent": "specular_exponent",
    "refractiveIndex": "refractive_index",
}


def _parse_material(obj: dict) -> dict:
    return {
        _MATERIAL_RENAME.get(key, key): fn(obj[key])
        for key, fn in _MATERIAL_KEYS.items()
        if key in obj
    }


def loads(text: str, aspect_ratio: float, device="cuda") -> Scene:
    """Parse scene JSON text onto ``device``."""
    check_device(device)
    data = _loads_tolerant(text)
    camera = Camera.default()
    background = np.zeros(4, np.float32)
    if "background" in data:
        background = parse_color(data["background"])
    if "camera" in data:
        camera = parse_camera(data["camera"], aspect_ratio)

    planes, spheres = [], []
    for obj in data.get("objects", []):
        typ = obj.get("type")
        if typ is None:
            continue
        transform = parse_transform(obj["transform"]) if "transform" in obj else math3d.identity()
        entry = {"transform": transform, "material": _parse_material(obj)}
        if typ == "sphere":
            entry["radius"] = float(obj["radius"])
            spheres.append(entry)
        elif typ == "plane":
            planes.append(entry)
    return make_scene(camera, background, planes, spheres, device)


def load(path: str, aspect_ratio: float, device="cuda") -> Scene:
    """Load a scene file onto ``device``."""
    with open(path, "r") as f:
        return loads(f.read(), aspect_ratio, device)
