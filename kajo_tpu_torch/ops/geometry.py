"""Ray geometry: camera basis, scene preparation, nearest-hit trace and NEE
visibility. Port of ``kajo_tpu/ops/geometry.py``.

Rays meet objects as dense tensor code (all rays x all objects, a masked
argmin over the object axis) up to ``STREAM_THRESHOLD`` spheres. Above it,
``prepare_scene`` packs the spheres for the streaming trace of
``ops/stream_trace.py`` (K5 nearest hit, K6 any-hit occlusion: CUDA kernels
on a GPU, their plain PyTorch versions on the CPU), and ``trace`` and
``light_visible`` go through it. Inverses and determinants are computed in
float32 on the scene's device, as the JAX code computes them.

Semantics kept from the reference: object ids are planes first, then
spheres, and a later object needs a strictly smaller t to win (the first
index wins a tie); hit distances in object space are scaled by the transform
determinant; plane normals are the *negated* rotated local +Y, not
re-normalized; plane tangents the rotated +X; ``t == 0`` is a hit; lights are
the emissive spheres listed in ``Scene.light_indices``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..scene.types import Camera, Materials, Scene
from .sampling import safe_normalize, safe_sqrt
from .stream_trace import (
    build_stream_scene,
    columns,
    general_records,
    nearest_sphere,
    object_ray,
    occluded_sphere,
    quadratic_general,
    quadratic_rigid,
    ray_terms,
)

FLT_EPSILON = 1.1920928955078125e-07
INF = float("inf")
# Scenes with more spheres than this take the streaming trace (K5/K6);
# tests lower it to stream small scenes.
STREAM_THRESHOLD = 1024


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

    ``rigid`` is True when every sphere transform is rigid: the trace then
    uses the world-space sphere record, and the object-space sphere fields
    (inv3, invt, fwd3, det) are empty. The ``stream_*`` fields are the
    streaming trace's packing (``stream_trace.build_stream_scene``), set
    when the scene has more than ``STREAM_THRESHOLD`` spheres, else None."""

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
    stream_packed: Optional[torch.Tensor] = None  # [S_pad, 4 | 14] packed-order records
    stream_boxes: Optional[torch.Tensor] = None   # [S_pad / 128, 8] block AABB, min det, 0
    stream_perm: Optional[torch.Tensor] = None    # [S_pad] packed row -> sphere index
    stream_inv_perm: Optional[torch.Tensor] = None  # [S] sphere index -> packed row, int32
    stream_sboxes: Optional[torch.Tensor] = None  # [ceil(S_pad / 1024), 8] superblocks of 8 blocks (K5)


@dataclasses.dataclass(frozen=True)
class SurfaceHit:
    """Nearest hits of a batch of rays; ``obj == -1`` is a miss."""

    t: torch.Tensor         # [N] world-space (determinant-scaled) distance, inf on miss
    obj: torch.Tensor       # [N] int64, -1 on miss
    position: torch.Tensor  # [N, 3]
    normal: torch.Tensor    # [N, 3]
    tangent: torch.Tensor   # [N, 3]
    binormal: torch.Tensor  # [N, 3]
    view: torch.Tensor      # [N, 3] incident ray direction


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


def generate_rays(basis: CameraBasis, sx: torch.Tensor, sy: torch.Tensor):
    """Camera rays through normalized screen coordinates -> (o, d) [N, 3].
    ``sy`` comes already flipped ((H - y) / H)."""
    d = basis.p1[None, :] + basis.du[None, :] * sx[:, None] + basis.dv[None, :] * sy[:, None] - basis.origin[None, :]
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return basis.origin.expand(d.shape), d


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
    prep = PreparedScene(
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
    if st.shape[0] > STREAM_THRESHOLD:
        # pack once per prepare: the wavefront traces many times per pass
        packed, boxes, perm, inv_perm, sboxes = build_stream_scene(prep)
        prep = dataclasses.replace(prep, stream_packed=packed, stream_boxes=boxes, stream_perm=perm,
                                   stream_inv_perm=inv_perm, stream_sboxes=sboxes)
    return prep


def _dot_rows(a, b):
    """[N, 3] x [M, 3] -> [N, M] dot products, summed x + y + z in float32
    elementwise ops (no matrix unit, so no TF32 question on the card)."""
    return a[:, 0:1] * b[:, 0] + a[:, 1:2] * b[:, 1] + a[:, 2:3] * b[:, 2]


def _intersect_planes(prep: PreparedScene, o, d):
    """Plane hits -> (t_world [N, P] with inf where invalid, t_loc [N, P])."""
    n, c = prep.plane_nrow[:, :3], prep.plane_nrow[:, 3]
    denom = _dot_rows(d, n)            # object-space d.y
    onum = _dot_rows(o, n) + c[None, :]  # object-space o.y
    t_loc = -onum / torch.where(denom == 0, 1.0, denom)
    t = t_loc * prep.plane_det[None, :]
    valid = (denom.abs() >= FLT_EPSILON) & (t_loc >= 0) & (t >= 0)
    return torch.where(valid, t, INF), t_loc


def _intersect_spheres(prep: PreparedScene, o, d):
    """Object-space sphere hits, det-scaled t, through the streaming trace's
    quadratic (so dense and streamed hits round alike) -> (t_world [N, S]
    with inf where invalid, t_loc [N, S])."""
    t, valid, t_loc = quadratic_general(general_records(prep).T, columns(o), columns(d))
    return torch.where(valid, t, INF), t_loc


def _intersect_spheres_rigid(prep: PreparedScene, o, d):
    """World-space sphere hits for rigid scenes, |o + t d - c|² = r² with
    |d| = 1; equal to the object-space form (an isometry with det 1) ->
    t [N, S] with inf where invalid. The quadratic is the streaming
    trace's, so dense and streamed hits round alike."""
    c = prep.sphere_center
    t, valid = quadratic_rigid(c[:, 0], c[:, 1], c[:, 2], prep.sphere_radius2, *ray_terms(o, d))
    return torch.where(valid, t, INF)


def _sphere_tangent(n):
    """Smallest-component permutation tangent; where the permuted vector
    degenerates (a normal exactly on a negative axis), a perpendicular built
    from a safe up axis instead of the reference's NaN."""
    zero = torch.zeros_like(n[..., 0])
    smallest = torch.minimum(n[..., 2], torch.minimum(n[..., 0], n[..., 1]))
    tx = torch.stack([zero, -n[..., 2], n[..., 1]], -1)
    ty = torch.stack([-n[..., 2], zero, n[..., 0]], -1)
    tz = torch.stack([-n[..., 1], n[..., 0], zero], -1)
    t = torch.where((n[..., 0] == smallest)[..., None], tx, torch.where((n[..., 1] == smallest)[..., None], ty, tz))
    norm2 = torch.sum(t * t, -1, keepdim=True)
    flat = (n[..., 1].abs() < 0.9)[..., None]
    # the axes filled on the device: no copy from the host (a CUDA graph
    # captures the wavefront's body)
    axes = torch.eye(3, dtype=n.dtype, device=n.device)
    up = torch.where(flat, axes[1], axes[0])
    t = torch.where(norm2 < 1e-12, torch.linalg.cross(n, up.expand(n.shape)), t)
    return safe_normalize(t)


def _gather_first(x, idx):
    return torch.gather(x, 1, idx[:, None])[:, 0]


def trace(prep: PreparedScene, o: torch.Tensor, d: torch.Tensor, t_max=None) -> SurfaceHit:
    """Nearest hit over all objects.

    ``t_max`` (optional, per ray) is a search bound: hits beyond it MAY be
    reported as misses. Only visibility queries pass it (their answer is an
    identity compare against an object within the bound). The streaming
    trace starts its search at it; the dense path ignores it."""
    num_p = prep.plane_nrow.shape[0]
    num_s = prep.sphere_radius2.shape[0]
    n = o.shape[0]
    if num_p + num_s == 0:  # empty scene: every ray misses
        z3 = torch.zeros_like(o)
        return SurfaceHit(
            t=o.new_full((n,), INF), obj=torch.full((n,), -1, dtype=torch.int64, device=o.device),
            position=o, normal=z3, tangent=z3, binormal=z3, view=d,
        )

    streamed = prep.stream_packed is not None
    if streamed:
        # planes dense first (P is small): their nearest hit bounds the
        # sphere search, so blocks beyond the ground are culled
        if num_p:
            tp, _ = _intersect_planes(prep, o, d)
            t_pl, pidx = torch.min(tp, dim=1)
        else:
            t_pl = o.new_full((n,), INF)
            pidx = torch.zeros((n,), dtype=torch.int64, device=o.device)
        bound = t_pl if t_max is None else torch.minimum(t_pl, t_max)
        t_sph, sidx_best = nearest_sphere(prep, o, d, bound)
        # planes scan first: a sphere needs a strictly smaller t to win
        sphere_wins = t_sph < t_pl
        obj = torch.where(sphere_wins, num_p + sidx_best, pidx)
        t = torch.where(sphere_wins, t_sph, t_pl)
        t_loc = t
    else:
        parts_t, parts_tloc = [], []
        if num_p:
            tp, tp_loc = _intersect_planes(prep, o, d)
            parts_t.append(tp)
            parts_tloc.append(tp_loc)
        if num_s:
            if prep.rigid:
                ts = _intersect_spheres_rigid(prep, o, d)
                ts_loc = ts  # det == 1: world t equals object-space t
            else:
                ts, ts_loc = _intersect_spheres(prep, o, d)
            parts_t.append(ts)
            parts_tloc.append(ts_loc)
        t_all = torch.cat(parts_t, 1)
        t, obj = torch.min(t_all, dim=1)  # first index of the minimum
        t_loc = _gather_first(torch.cat(parts_tloc, 1), obj)
    hit = torch.isfinite(t)

    is_sphere = obj >= num_p
    sidx = torch.clamp(obj - num_p, 0, max(num_s - 1, 0))
    if num_s and prep.rigid:
        # world normal = (hit point - center) / radius, normalized
        hit_pos = o + d * torch.where(hit, t, 0.0)[:, None]
        n_sph = safe_normalize(hit_pos - prep.sphere_center[sidx])
    elif num_s:
        # the winner's object-space ray, by the quadratic's own arithmetic
        rec = prep.stream_packed[prep.stream_inv_perm[sidx]] if streamed else general_records(prep)[sidx]
        (ox, oy, oz), (dx, dy, dz) = object_ray(rec.T, tuple(o.T), tuple(d.T))
        if streamed:
            det_w = prep.sphere_det[sidx]
            tl = torch.where(hit, t, 0.0) / torch.where(det_w == 0, 1.0, det_w)
        else:
            tl = t_loc
        n_loc = torch.stack([ox + dx * tl, oy + dy * tl, oz + dz * tl], 1)
        n_sph = safe_normalize((prep.sphere_fwd3[sidx] * n_loc[:, None, :]).sum(-1))
    else:
        n_sph = torch.zeros_like(o)
    t_sph = _sphere_tangent(n_sph) if num_s else torch.zeros_like(o)

    if num_p:
        pidx = torch.clamp(obj, 0, num_p - 1)
        n_pl, tg_pl = prep.plane_normal[pidx], prep.plane_tangent[pidx]
    else:
        n_pl = tg_pl = torch.zeros_like(o)

    normal = torch.where(is_sphere[:, None], n_sph, n_pl)
    tangent = torch.where(is_sphere[:, None], t_sph, tg_pl)
    binormal = torch.linalg.cross(normal, tangent)
    h3 = hit[:, None]
    return SurfaceHit(
        t=torch.where(hit, t, INF),
        obj=torch.where(hit, obj, -1),
        position=o + d * torch.where(hit, t, 0.0)[:, None],
        normal=torch.where(h3, normal, 0.0),
        tangent=torch.where(h3, tangent, 0.0),
        binormal=torch.where(h3, binormal, 0.0),
        view=d,
    )


def light_visible(prep: PreparedScene, o, d, center, radius, lobj, needed=None, trace_fn=None):
    """NEE visibility: does the nearest hit along (o, d) land on light
    ``lobj``? (``center``/``radius``/``lobj`` per ray: [M, 3], [M], [M].)

    Semantics: ``trace(prep, o, d).obj == lobj``: the shadow ray must find
    the light, so any strictly nearer object occludes. ``needed`` (bool [M],
    optional) marks the lanes whose NEE term can be nonzero; the others get
    a zero search bound and an unspecified answer (the caller masks them).

    Rigid streamed scenes take the any-hit path: the light's own hit t is
    closed-form (the same quadratic, the same operand order and inputs as
    the kernel's), so visibility is "no plane at t <= t_light" (dense) and
    "no other sphere strictly below t_light" (K6, the light's own packed
    index excluded, so it never occludes itself). Other scenes, and a
    ``trace_fn`` other than ``trace`` (the object-sharded trace of
    ``parallel/objshard.py``), trace the nearest hit through it, bounded by
    dist + radius + 1."""
    trace_fn = trace if trace_fn is None else trace_fn
    if trace_fn is not trace or not (prep.stream_packed is not None and prep.rigid):
        dist = torch.linalg.norm(center - o, dim=-1)
        return trace_fn(prep, o, d, t_max=dist + radius + 1.0).obj == lobj

    # one sphere per ray: [M, 1] columns against [M, 1] centers
    c = center[:, :, None]
    t_l, valid_l = quadratic_rigid(c[:, 0], c[:, 1], c[:, 2], (radius * radius)[:, None], *ray_terms(o, d))
    t_l, valid_l = t_l[:, 0], valid_l[:, 0]

    num_p = prep.plane_nrow.shape[0]
    if num_p:
        tp, _ = _intersect_planes(prep, o, d)
        t_pl = torch.min(tp, dim=1).values
        plane_occ = t_pl <= t_l  # the nearest scan gives a tie to the plane
    else:
        t_pl = torch.full_like(t_l, INF)
        plane_occ = torch.zeros_like(valid_l)

    # the light's packed row, excluded in the kernel
    num_s = prep.sphere_radius2.shape[0]
    excl = prep.stream_inv_perm[torch.clamp(lobj - num_p, 0, num_s - 1)]
    t_cut = torch.where(valid_l, torch.minimum(t_l, t_pl), 0.0)  # light missed: occluded
    if needed is not None:
        t_cut = torch.where(needed, t_cut, 0.0)  # dead NEE term: no search
    return valid_l & ~plane_occ & ~occluded_sphere(prep, o, d, t_cut, excl)
