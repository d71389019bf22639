"""Camera basis and trace-ready scene preparation.

Port of ``camera_basis`` and ``prepare_scene`` from ``kajo_tpu/ops/geometry.py``.
Inverses and determinants are computed in float32 on the scene's device, as
the JAX code computes them in float32. The stream fields of the JAX
``PreparedScene`` (the big-scene trace cache) and the dense ``trace`` /
``light_visible`` belong to later slices of the port.

Semantics kept from the reference: hit distances in object space are scaled
by the transform determinant; plane normals are the *negated* rotated local
+Y, not re-normalized; plane tangents the rotated +X; lights are the
emissive spheres listed in ``Scene.light_indices``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..scene.types import Camera, Materials, Scene


@dataclasses.dataclass(frozen=True)
class CameraBasis:
    """Image-plane basis from unprojected viewport corners."""

    origin: torch.Tensor  # [3]
    p1: torch.Tensor      # [3] world point of screen (0,0) on the near plane
    du: torch.Tensor      # [3] p2 - p1 (screen +x)
    dv: torch.Tensor      # [3] p3 - p1 (screen +y)


@dataclasses.dataclass(frozen=True)
class PreparedScene:
    """Derived, trace-ready scene; every tensor is a function of Scene tensors.

    ``rigid`` is True when every sphere transform is rigid: the kernels then
    use the world-space sphere record, and the object-space sphere fields
    (inv3, invt, fwd3, det) are empty."""

    plane_nrow: torch.Tensor      # [P, 4] inv[1, :]: o_loc.y = nrow[:3]·o + nrow[3]
    plane_det: torch.Tensor       # [P]
    plane_normal: torch.Tensor    # [P, 3] world normal = -fwd3 @ (0,1,0) (unnormalized)
    plane_tangent: torch.Tensor   # [P, 3] world tangent = fwd3 @ (1,0,0)
    sphere_inv3: torch.Tensor     # [S, 3, 3]
    sphere_invt: torch.Tensor     # [S, 3]
    sphere_fwd3: torch.Tensor     # [S, 3, 3]
    sphere_det: torch.Tensor      # [S]
    sphere_radius2: torch.Tensor  # [S]
    sphere_center: torch.Tensor   # [S, 3] world-space centers (translation column)
    rigid: bool
    light_center: torch.Tensor    # [L, 3]
    light_radius: torch.Tensor    # [L]
    light_emission: torch.Tensor  # [L, 4]
    light_obj: torch.Tensor       # [L] int64 object id (planes-first indexing)
    materials: Materials          # K = P + S
    background: torch.Tensor      # [4]
    camera: CameraBasis


def _unproject(win, inv):
    """GLM unProject with the unit viewport, given inv(proj @ view)."""
    v = torch.cat([win * 2.0 - 1.0, win.new_ones(1)])
    out = inv @ v
    return out[:3] / out[3]


def camera_basis(camera: Camera) -> CameraBasis:
    view = camera.transform.to(torch.float32)
    proj = camera.projection.to(torch.float32)
    inv = torch.linalg.inv(proj @ view)
    corner = view.new_tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    p1, p2, p3 = (_unproject(c, inv) for c in corner)
    origin = (torch.linalg.inv(view) @ view.new_tensor([0.0, 0.0, 0.0, 1.0]))[:3]
    return CameraBasis(origin=origin, p1=p1, du=p2 - p1, dv=p3 - p1)


def prepare_scene(scene: Scene) -> PreparedScene:
    pt = scene.plane_transform.to(torch.float32)
    st = scene.sphere_transform.to(torch.float32)
    radius = scene.sphere_radius.to(torch.float32)
    rigid = bool(scene.rigid_spheres)
    num_planes = pt.shape[0]

    plane_inv = torch.linalg.inv(pt) if num_planes else pt
    # rigid scenes never read the object-space sphere fields
    if rigid or st.shape[0] == 0:
        sphere_inv, sphere_fwd, sphere_det = st[:0], st[:0], radius[:0]
    else:
        sphere_inv, sphere_fwd, sphere_det = torch.linalg.inv(st), st, torch.linalg.det(st)

    light_idx = torch.tensor(scene.light_indices, dtype=torch.int64, device=st.device)
    mats = scene.materials
    return PreparedScene(
        plane_nrow=plane_inv[:, 1, :],
        plane_det=torch.linalg.det(pt) if num_planes else radius[:0],
        plane_normal=-pt[:, :3, 1],
        plane_tangent=pt[:, :3, 0],
        sphere_inv3=sphere_inv[:, :3, :3],
        sphere_invt=sphere_inv[:, :3, 3],
        sphere_fwd3=sphere_fwd[:, :3, :3],
        sphere_det=sphere_det,
        sphere_radius2=radius * radius,
        sphere_center=st[:, :3, 3],
        rigid=rigid,
        light_center=st[light_idx][:, :3, 3],
        light_radius=radius[light_idx],
        light_emission=mats.emission[num_planes + light_idx],
        light_obj=num_planes + light_idx,
        materials=mats,
        background=scene.background.to(torch.float32),
        camera=camera_basis(scene.camera),
    )
