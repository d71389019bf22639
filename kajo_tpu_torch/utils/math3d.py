"""GLM-0.9.3-compatible 3D transform math on numpy, for scene construction.

The port's own copy of the numpy path of ``kajo_tpu/utils/math3d.py``: the
scene DSL composes ``lookat``/``translate``/``scale``/``rotate`` into one
mat4 with GLM 0.9.3 semantics: angles in **degrees**, composition
``result @ X``, the classic OpenGL ``lookAt`` and symmetric-frustum
``perspective``. Inputs and outputs are float32 numpy arrays; the same
operations in the same order as the JAX package's numpy path, so the two
packages build identical scenes.

Matrix convention: (4, 4) arrays applied to column vectors, ``M @ v``.

:func:`project` is the JAX path's projection on PyTorch tensors, for the
boundary terms (``diff/edges.py``): float32 and differentiable.
"""

from __future__ import annotations

import numpy as np
import torch


def identity() -> np.ndarray:
    return np.eye(4, dtype=np.float32)


def translate(m: np.ndarray, v) -> np.ndarray:
    """GLM translate: ``m * T(v)``."""
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = np.asarray(v, dtype=np.float32)
    return (m @ t).astype(np.float32)


def scale(m: np.ndarray, v) -> np.ndarray:
    """GLM scale: ``m * S(v)``."""
    s = np.eye(4, dtype=np.float32)
    v = np.asarray(v, dtype=np.float32)
    s[0, 0], s[1, 1], s[2, 2] = v[0], v[1], v[2]
    return (m @ s).astype(np.float32)


def rotation_matrix(angle_deg: float, axis) -> np.ndarray:
    """GLM rotate matrix (angle in degrees, axis normalized internally)."""
    a = np.deg2rad(np.asarray(angle_deg, dtype=np.float32))
    c = np.cos(a)
    s = np.sin(a)
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
    return out


def rotate(m: np.ndarray, angle_deg: float, axis) -> np.ndarray:
    """GLM rotate: ``m * R(angle_deg, axis)``."""
    return (m @ rotation_matrix(angle_deg, axis)).astype(np.float32)


def look_at(eye, center, up) -> np.ndarray:
    """GLM lookAt view matrix (right-handed)."""
    eye = np.asarray(eye, dtype=np.float32)
    center = np.asarray(center, dtype=np.float32)
    up = np.asarray(up, dtype=np.float32)
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


def perspective(fovy_deg: float, aspect: float, z_near: float, z_far: float) -> np.ndarray:
    """GLM 0.9.3 perspective (fovy in **degrees**, symmetric frustum). The
    scene DSL's ``perspective(fovy, near, far)`` takes the aspect from the
    caller."""
    rng = np.tan(np.deg2rad(float(fovy_deg)) / 2.0) * float(z_near)
    left, right = -rng * float(aspect), rng * float(aspect)
    bottom, top = -rng, rng
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = 2.0 * z_near / (right - left)
    m[1, 1] = 2.0 * z_near / (top - bottom)
    m[2, 2] = -(z_far + z_near) / (z_far - z_near)
    m[2, 3] = -(2.0 * z_far * z_near) / (z_far - z_near)
    m[3, 2] = -1.0
    return m


def _mat_vec(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Rows of ``m`` [R, 3] dotted with points ``p`` [..., 3] -> [..., R],
    as float32 products and sums: no matrix unit, so no TF32 on the card
    (the JAX path asks for ``Precision.HIGHEST`` for the same reason)."""
    return p[..., None, 0] * m[:, 0] + p[..., None, 1] * m[:, 1] + p[..., None, 2] * m[:, 2]


def project(p: torch.Tensor, view: torch.Tensor, proj: torch.Tensor):
    """World points [..., 3] -> ((x, y, depth) in [0, 1]³, clip-space w); the
    inverse of the camera's unproject. ``w > 0`` is in front of the camera."""
    view, proj = view.to(torch.float32), proj.to(torch.float32)
    pv = (proj[:, :, None] * view[None, :, :]).sum(1)
    h = _mat_vec(pv[:3, :3], p) + pv[:3, 3]
    w = _mat_vec(pv[3:, :3], p)[..., 0] + pv[3, 3]
    ndc = h / w[..., None]
    return (ndc + 1.0) * 0.5, w
