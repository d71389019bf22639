"""The plain reference of the 100k-sphere field: a frozen copy, in plain
PyTorch and numpy, of what a progressive render of
``random_spheres_scene`` through the port's streamed wavefront (engine
``fast`` above 1,024 spheres, K5/K6) computes.

- :func:`field_arrays`: the procedural scene's host arrays (the generator's
  calls in the generator's order, GLM's translate/look-at/perspective);
- :func:`prepare`: the scene's preparation for a rigid streamed scene
  (camera basis, the plane's inverse, the light table) and the streaming
  trace's packing (Morton order, 128-sphere blocks with boxes, blocks
  ordered front to back from the camera);
- :func:`nearest` and :func:`occluded`: the block-culled scans of K5 and K6
  (blocks in packed order, a block skipped for a ray whose slab test
  against its live bound fails, a strict ``t < t_best``, the first packed
  row winning a tie; an occluded ray stops). They test only the (ray,
  block) pairs whose slab test admits the ray at its starting bound and
  then walk the blocks in order with the live bound, which gives the
  whole scan's answer: a pair left out could not have been admitted;
- :func:`render_batch`: the regenerating wavefront of one or more passes
  (each pixel's samples split over ``LANE_MULT`` lanes that walk the image
  in 64x64 screen tiles), of the whole image or of whole screen tiles
  only: a tile's pixels are rendered by all their lanes, under their own
  lane ids, so they come out as in the whole render.

It imports neither ``jax`` nor the JAX package nor anything of the port.
Only the rigid sphere record and a streamed scene (more than 1,024
spheres) are copied; the estimator's GL mode is not. ``dtype`` is the
arithmetic's type: float32 is the reference; a lower one is the
benchmark's control (``bfloat16``; the scene is prepared in float32, then
cast). With ``tally``, each trace call appends what a block-culled scan
must test by the rule of ``chip_smoke.py`` ``call_bound``, from which the
benchmark counts K5's and K6's work.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .rng import pass_seed, uniforms4
from .walk import Estimator

FLT_EPSILON = 1.1920928955078125e-07
INF = float("inf")
BIG = float(np.float32(3.0e38))
PI = float(np.float32(np.pi))
INV_PI = float(np.float32(1.0 / np.pi))
BLOCK = 128  # spheres a block
STREAM_THRESHOLD = 1024
CAMERA_SALT = 0x7FFFFFFF
LANE_MULT = 4
TILE_TS = 64
# (ray, sphere) elements of one intermediate of the scans
CHUNK_ELEMS = 1 << 24


# ------------------------------------------------------------- the scene
def _translate(m, v):
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = np.asarray(v, dtype=np.float32)
    return (m @ t).astype(np.float32)


def _look_at(eye, center, up):
    eye, center, up = (np.asarray(x, dtype=np.float32) for x in (eye, center, up))
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
    bottom, top = -rng, rng
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = 2.0 * z_near / (right - left)
    m[1, 1] = 2.0 * z_near / (top - bottom)
    m[2, 2] = -(z_far + z_near) / (z_far - z_near)
    m[2, 3] = -(2.0 * z_far * z_near) / (z_far - z_near)
    m[3, 2] = -1.0
    return m


def field_arrays(n_spheres: int, seed: int, extent: float = 60.0, n_lights: int = 4,
                 aspect_ratio: float = 4.0 / 3.0) -> dict:
    """The host arrays of ``random_spheres_scene(n_spheres, seed, extent,
    n_lights, aspect_ratio)`` without scale jitter: ``view``,
    ``projection``, ``background``, ``plane_transform`` [1, 4, 4],
    ``sphere_transform`` [S, 4, 4], ``sphere_radius`` [S], the material
    fields [P + S, ...] (planes first), ``light_indices`` and ``rigid``."""
    rng = np.random.default_rng(seed)
    pos = np.empty((n_spheres, 3), np.float32)
    pos[:, 0] = rng.uniform(-extent, extent, n_spheres)
    pos[:, 2] = rng.uniform(-extent, extent, n_spheres)
    radii = rng.uniform(0.1, 0.45, n_spheres).astype(np.float32)
    pos[:, 1] = 1.0 - radii
    hues = rng.uniform(0.2, 1.0, (n_spheres, 3)).astype(np.float32)
    shiny = rng.uniform(0, 1, n_spheres) < 0.2
    n_s = n_spheres + n_lights
    k = 1 + n_s
    mats = {name: np.zeros((k, 4), np.float32) for name in ("ambient", "diffuse", "specular", "emission",
                                                             "transparency")}
    mats["specular_exponent"] = np.zeros((k,), np.float32)
    mats["refractive_index"] = np.ones((k,), np.float32)
    sphere_t = np.tile(np.eye(4, dtype=np.float32), (n_s, 1, 1))
    sphere_r = np.zeros((n_s,), np.float32)
    ident = np.eye(4, dtype=np.float32)
    for i in range(n_spheres):
        hue = np.append(hues[i], 1.0)
        if shiny[i]:
            mats["specular"][1 + i] = hue
            mats["specular_exponent"][1 + i] = float(rng.integers(20, 200))
        else:
            mats["diffuse"][1 + i] = hue
        sphere_t[i] = _translate(ident, pos[i])
        sphere_r[i] = radii[i]
    for i in range(n_lights):
        ang = 2 * np.pi * i / max(n_lights, 1)
        sphere_t[n_spheres + i] = _translate(ident, [0.5 * extent * np.cos(ang), -8.0, 0.5 * extent * np.sin(ang)])
        sphere_r[n_spheres + i] = np.float32(1.5)
        mats["emission"][1 + n_spheres + i] = np.array([60, 60, 60, 0], np.float32)
    mats["diffuse"][0] = np.array([0.5, 0.5, 0.5, 1], np.float32)
    linear = sphere_t[:, :3, :3]
    rigid = bool(
        np.allclose(np.einsum("sij,skj->sik", linear, linear), np.eye(3, dtype=np.float32)[None], atol=1e-5)
        and np.allclose(np.linalg.det(linear), 1.0, atol=1e-5)
    )
    return dict(
        view=_look_at([-0.8 * extent, -6.0, -0.8 * extent], [0, 0, 0], [0, -1, 0]),
        projection=_perspective(55.0, aspect_ratio, 0.1, 10.0 * extent),
        background=np.array([0.01, 0.01, 0.02, 1], np.float32),
        plane_transform=_translate(ident, [0, 1, 0])[None],
        sphere_transform=sphere_t,
        sphere_radius=sphere_r,
        materials=mats,
        light_indices=tuple(int(i) for i in range(n_s) if np.any(mats["emission"][1 + i] != 0.0)),
        rigid=rigid,
    )


# ------------------------------------------------------------ arithmetic
def _sqrt(x):
    """The correctly rounded square root: a float64 root rounded once."""
    return torch.sqrt(x.double()).to(x.dtype)


def _pow(x, n):
    return torch.pow(x.double(), n.double() if isinstance(n, torch.Tensor) else n).to(x.dtype)


def safe_sqrt(x):
    m = x > 0
    return torch.where(m, _sqrt(torch.where(m, x, 1.0)), 0.0)


def safe_pow(x, n):
    m = x > 0
    return torch.where(m, _pow(torch.where(m, x, 1.0), n), torch.where(n == 0, 1.0, 0.0))


def safe_normalize(v):
    n2 = torch.sum(v * v, -1, keepdim=True)
    m = n2 > 0
    return torch.where(m, v * torch.rsqrt(torch.where(m, n2, 1.0)), 0.0)


def _dot(a, b, keepdim=True):
    return torch.sum(a * b, -1, keepdim=keepdim)


def _reflect(v, n):
    return v - 2.0 * _dot(n, v) * n


def _flip_coin(u, probability):
    took = (probability > 0) & (u <= probability)
    return took, torch.where(took, probability, 1.0 - probability)


# ------------------------------------------------------- the BSDFs, lights
def _cosine_hemisphere(u1, u2):
    r = _sqrt(u1)
    phi = u2 * 2.0 * PI
    z = _sqrt(torch.clamp_min(1.0 - u1, 0.0))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1), z * INV_PI


def _lambert_sample(u1, u2, tangent, binormal, normal):
    dl, pdf = _cosine_hemisphere(u1, u2)
    return tangent * dl[..., 0:1] + binormal * dl[..., 1:2] + normal * dl[..., 2:3], pdf


def _lambert_eval_cos(diffuse, normal, direction):
    return diffuse * INV_PI * torch.clamp_min(_dot(normal, direction), 0.0)


def _lambert_pdf(normal, direction):
    return INV_PI * _dot(normal, direction, keepdim=False)


def _phong_sample(u1, u2, view, normal, exponent):
    r = _reflect(view, normal)
    z = torch.tensor([0.0, 0.0, 1.0], dtype=r.dtype, device=r.device).expand(r.shape)
    u = torch.linalg.cross(z, r)
    degenerate = _dot(u, u) < 1e-12
    y = torch.tensor([0.0, 1.0, 0.0], dtype=r.dtype, device=r.device).expand(r.shape)
    u = safe_normalize(torch.where(degenerate, torch.linalg.cross(y, r), u))
    v = torch.linalg.cross(u, r)
    cos_a = safe_pow(u1, 1.0 / (exponent + 1.0))
    phi = 2.0 * PI * u2
    sin_a = safe_sqrt(1.0 - cos_a * cos_a)
    dl = torch.stack([sin_a * torch.cos(phi), sin_a * torch.sin(phi), cos_a], -1)
    pdf = (exponent + 1.0) / (2.0 * PI) * safe_pow(cos_a, exponent)
    return u * dl[..., 0:1] + v * dl[..., 1:2] + r * dl[..., 2:3], pdf


def _phong_eval_cos(specular, view, normal, direction, exponent):
    r = _reflect(view, normal)
    cos_a = torch.clamp_min(_dot(r, direction), 0.0)
    e = exponent[..., None]
    lobe = (e + 1.0) / (2.0 * PI) * safe_pow(cos_a, e)
    return specular * lobe * torch.clamp_min(_dot(normal, direction), 0.0)


def _phong_pdf(view, normal, direction, exponent):
    r = _reflect(view, normal)
    cos_a = torch.clamp_min(_dot(r, direction, keepdim=False), 0.0)
    return (exponent + 1.0) / (2.0 * PI) * safe_pow(cos_a, exponent)


def _transmission_sample(view, normal, refractive_index):
    entering = _dot(view, normal) < 0
    n_eff = torch.where(entering, normal, -normal)
    ior = refractive_index[..., None]
    eta = torch.where(entering, 1.0 / ior, ior)
    cos_i = _dot(view, n_eff)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    refracted = eta * view - (eta * cos_i + safe_sqrt(k)) * n_eff
    return torch.where(k < 0, _reflect(view, n_eff), refracted)


def _solid_angle(center, radius, position):
    d2 = torch.sum((center - position) ** 2, -1)
    dist = torch.sqrt(torch.clamp_min(d2, 1e-20))
    x = torch.clamp(radius / dist, 0.0, 1.0)
    c = torch.sqrt(torch.clamp_min(1.0 - x * x, 1e-12))
    omega = 2.0 * PI * (x * x) / (1.0 + c)
    return torch.where(dist < radius, 4.0 * PI, omega)


def _light_sample(u1, u2, u3, center, radius, position):
    x = radius * torch.sqrt(u1) * torch.cos(2.0 * PI * u2)
    y = radius * torch.sqrt(u1) * torch.sin(2.0 * PI * u2)
    z = safe_sqrt(radius * radius - x * x - y * y) * torch.sin(PI * (u3 - 0.5))
    d = safe_normalize(center + torch.stack([x, y, z], -1) - position)
    return d, 1.0 / _solid_angle(center, radius, position)


# ------------------------------------------------------ the preparation
@dataclasses.dataclass(frozen=True)
class Field:
    """A prepared rigid streamed field on one device."""

    plane_nrow: torch.Tensor  # [P, 4]
    plane_det: torch.Tensor  # [P]
    plane_normal: torch.Tensor  # [P, 3]
    plane_tangent: torch.Tensor  # [P, 3]
    sphere_center: torch.Tensor  # [S, 3]
    light_center: torch.Tensor  # [L, 3]
    light_radius: torch.Tensor  # [L]
    light_emission: torch.Tensor  # [L, 4]
    light_obj: torch.Tensor  # [L] int64
    mat: dict  # name -> [K, 3] or [K]
    background: torch.Tensor  # [4]
    origin: torch.Tensor  # [3] camera basis
    p1: torch.Tensor
    du: torch.Tensor
    dv: torch.Tensor
    packed: torch.Tensor  # [S_pad, 4] cx, cy, cz, r2 in packed order
    boxes: torch.Tensor  # [B, 8] lo, hi, min det, 0
    perm: torch.Tensor  # [S_pad] packed row -> sphere
    inv_perm: torch.Tensor  # [S] sphere -> packed row, int32


def _expand_bits10(v):
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def _unproject(win, inv):
    v = torch.cat([win * 2.0 - 1.0, win.new_ones(1)])
    out = inv @ v
    return out[:3] / out[3]


def prepare(arrays: dict, device, dtype=torch.float32) -> Field:
    """The prepared field of :func:`field_arrays`' arrays on ``device``,
    prepared in float32, its floats then cast to ``dtype``."""
    if not arrays["rigid"] or arrays["sphere_radius"].shape[0] <= STREAM_THRESHOLD:
        raise ValueError("the field's reference takes a rigid scene of more than 1,024 spheres")

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    pt = f32(arrays["plane_transform"])
    st = f32(arrays["sphere_transform"])
    radius = f32(arrays["sphere_radius"])
    mats = {k: f32(v) for k, v in arrays["materials"].items()}
    num_p = pt.shape[0]
    light_idx = torch.tensor(arrays["light_indices"], dtype=torch.int64, device=device)
    view, proj = f32(arrays["view"]), f32(arrays["projection"])
    inv = torch.linalg.inv(proj @ view)
    corner = view.new_tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    p1, p2, p3 = (_unproject(c, inv) for c in corner)
    origin = (torch.linalg.inv(view) @ view.new_tensor([0.0, 0.0, 0.0, 1.0]))[:3]
    plane_inv = torch.linalg.inv(pt)
    r2 = radius * radius
    center = st[:, :3, 3]

    # the streaming trace's packing
    s = center.shape[0]
    lo_c, hi_c = torch.min(center, 0).values, torch.max(center, 0).values
    q = torch.clamp((center - lo_c) / torch.clamp_min(hi_c - lo_c, 1e-20) * 1023.0, 0.0, 1023.0).to(torch.int64)
    code = (_expand_bits10(q[:, 0]) << 2) | (_expand_bits10(q[:, 1]) << 1) | _expand_bits10(q[:, 2])
    perm = torch.argsort(code, stable=True)
    packed = torch.cat([center, r2[:, None]], 1)[perm]
    ext = safe_sqrt(r2)[perm][:, None].expand(s, 3)
    centers = center[perm]
    s_pad = -(-s // BLOCK) * BLOCK
    pad = s_pad - s
    pad_rows = torch.zeros((pad, 4), dtype=torch.float32, device=device)
    pad_rows[:, -1] = -1.0
    packed = torch.cat([packed, pad_rows])
    centers = torch.cat([centers, centers[-1:].expand(pad, 3)])
    ext = torch.cat([ext, torch.zeros((pad, 3), dtype=torch.float32, device=device)])
    dets = torch.cat([torch.ones(s, dtype=torch.float32, device=device),
                      torch.full((pad,), BIG, dtype=torch.float32, device=device)])
    n_blocks = s_pad // BLOCK
    lo = torch.min((centers - ext).reshape(n_blocks, BLOCK, 3), 1).values
    hi = torch.max((centers + ext).reshape(n_blocks, BLOCK, 3), 1).values
    mind = torch.min(dets.reshape(n_blocks, BLOCK), 1).values[:, None]
    slack = 1e-4 * (torch.max(hi) - torch.min(lo) + 1.0)
    boxes = torch.cat([lo - slack, hi + slack, mind, torch.zeros((n_blocks, 1), dtype=torch.float32, device=device)], 1)
    perm = torch.cat([perm, torch.zeros((pad,), dtype=perm.dtype, device=device)])
    rows = torch.arange(s_pad, device=device)
    gap = torch.clamp_min(lo - origin[None, :], 0.0) + torch.clamp_min(origin[None, :] - hi, 0.0)
    order = torch.argsort(torch.sum(gap * gap, 1), stable=True)
    packed = packed.reshape(n_blocks, BLOCK, -1)[order].reshape(s_pad, -1)
    boxes = boxes[order]
    perm = perm.reshape(n_blocks, BLOCK)[order].reshape(s_pad)
    rows = rows.reshape(n_blocks, BLOCK)[order].reshape(s_pad)
    inv_perm = torch.zeros(s + 1, dtype=torch.int32, device=device)
    inv_perm[torch.where(rows < s, perm, s)] = torch.arange(s_pad, dtype=torch.int32, device=device)

    def cast(x):
        return x.to(dtype).contiguous()

    return Field(
        plane_nrow=cast(plane_inv[:, 1, :]),
        plane_det=cast(torch.linalg.det(pt)),
        plane_normal=cast(-pt[:, :3, 1]),
        plane_tangent=cast(pt[:, :3, 0]),
        sphere_center=cast(center),
        light_center=cast(st[light_idx][:, :3, 3]),
        light_radius=cast(radius[light_idx]),
        light_emission=cast(mats["emission"][num_p + light_idx]),
        light_obj=num_p + light_idx,
        mat={
            "diffuse": cast(mats["diffuse"][:, :3]),
            "specular": cast(mats["specular"][:, :3]),
            "emission": cast(mats["emission"][:, :3]),
            "transparency": cast(mats["transparency"][:, :3]),
            "specular_exponent": cast(mats["specular_exponent"]),
            "refractive_index": cast(mats["refractive_index"]),
        },
        background=cast(f32(arrays["background"])),
        origin=cast(origin),
        p1=cast(p1),
        du=cast(p2 - p1),
        dv=cast(p3 - p1),
        packed=cast(packed),
        boxes=cast(boxes),
        perm=perm.contiguous(),
        inv_perm=inv_perm[:s].contiguous(),
    )


# ------------------------------------------------------ K5's and K6's scans
def _ray_terms(o, d):
    ocol = tuple(o[:, i : i + 1] for i in range(3))
    dcol = tuple(d[:, i : i + 1] for i in range(3))
    d_dot_o = dcol[0] * ocol[0] + dcol[1] * ocol[1] + dcol[2] * ocol[2]
    o2 = ocol[0] * ocol[0] + ocol[1] * ocol[1] + ocol[2] * ocol[2]
    return ocol, dcol, d_dot_o, o2


def _quadratic(cx, cy, cz, r2, o, d, d_dot_o, o2):
    """The rigid sphere's stable quadratic with |d| = 1 -> (t, valid); sums
    left to right, as K5 takes them."""
    k = cx * cx + cy * cy + cz * cz - r2
    d_dot_c = d[0] * cx + d[1] * cy + d[2] * cz
    o_dot_c = o[0] * cx + o[1] * cy + o[2] * cz
    b = 2.0 * (d_dot_o - d_dot_c)
    cq = o2 - 2.0 * o_dot_c + k
    discr = b * b - 4.0 * cq
    sq = safe_sqrt(discr)
    q = torch.where(b < 0, (-b - sq) * 0.5, (-b + sq) * 0.5)
    t1 = cq / torch.where(q == 0, 1.0, q)
    lo = torch.minimum(q, t1)
    hi = torch.maximum(q, t1)
    t = torch.where(lo < 0, hi, lo)
    valid = (discr >= 0) & (hi >= 0) & (q != 0) & (t >= 0)
    return t, valid


def _slab(o, d, boxes):
    """Every ray against every block's box, the kernels' float operations
    -> (t_enter [N, B], entered [N, B])."""
    inv = torch.where(d == 0, BIG, 1.0 / torch.where(d == 0, 1.0, d))
    t_enter = torch.zeros((o.shape[0], boxes.shape[0]), dtype=o.dtype, device=o.device)
    t_exit = torch.full_like(t_enter, BIG)
    for ax in range(3):
        oa, da, ia = o[:, ax : ax + 1], d[:, ax : ax + 1], inv[:, ax : ax + 1]
        lo, hi = boxes[:, ax], boxes[:, 3 + ax]
        inside = (oa >= lo) & (oa <= hi)
        t0 = (lo - oa) * ia
        t1 = (hi - oa) * ia
        near, far = torch.fmin(t0, t1), torch.fmax(t0, t1)
        near = torch.where(da == 0, torch.where(inside, -BIG, BIG), near)
        far = torch.where(da == 0, torch.where(inside, BIG, -BIG), far)
        t_enter = torch.fmax(t_enter, near)
        t_exit = torch.fmin(t_exit, far)
    return t_enter, t_exit >= t_enter


def _candidates(o, d, bound, boxes):
    """The (ray, block) pairs whose slab test admits the ray below its
    starting bound, sorted by block then ray -> (block [M], ray [M],
    t_enter times the block's min det [M]); the live bound only falls, so
    every pair a scan admits is among them."""
    n, n_blocks = o.shape[0], boxes.shape[0]
    step = max(1, CHUNK_ELEMS // max(n_blocks, 1))
    blk, ray, ted = [], [], []
    for r0 in range(0, n, step):
        t_enter, entered = _slab(o[r0 : r0 + step], d[r0 : r0 + step], boxes)
        t_det = t_enter * boxes[:, 6]
        b, r = torch.nonzero((entered & (t_det < bound[r0 : r0 + step, None])).T, as_tuple=True)
        blk.append(b)
        ray.append(r + r0)
        ted.append(t_det[r, b])
    blk, ray, ted = torch.cat(blk), torch.cat(ray), torch.cat(ted)
    order = torch.argsort(blk * n + ray)
    return blk[order], ray[order], ted[order]


def _pair_tests(o, d, packed, blk, ray, reduce):
    """Each pair's ray against its block's 128 spheres, in chunks of pairs:
    ``reduce(t [m, 128], valid [m, 128], pairs)`` of each chunk, the
    results concatenated."""
    spheres = packed.view(-1, BLOCK, packed.shape[1])
    step = max(1, CHUNK_ELEMS // BLOCK)
    out = []
    for p0 in range(0, max(blk.shape[0], 1), step):
        pairs = slice(p0, p0 + step)
        b, r = blk[pairs], ray[pairs]
        rec = spheres[b]  # [m, 128, 4]
        t, valid = _quadratic(rec[..., 0], rec[..., 1], rec[..., 2], rec[..., 3], *_ray_terms(o[r], d[r]))
        out.append(reduce(t, valid, pairs))
    return tuple(torch.cat(x) for x in zip(*out))


def _segments(blk) -> list:
    """(block, start, end) of each block's run of the sorted pairs."""
    counts = torch.bincount(blk).tolist() if blk.numel() else []
    out, s = [], 0
    for b, c in enumerate(counts):
        if c:
            out.append((b, s, s + c))
            s += c
    return out


def _needed_entered(o, d, t_final, boxes):
    """Per ray and block, whether the ray enters the box below
    ``t_final`` -> bool [N, B] (``chip_smoke.py`` ``blocks_entered``)."""
    step = max(1, CHUNK_ELEMS // max(boxes.shape[0], 1))
    out = []
    for r0 in range(0, o.shape[0], step):
        t_enter, entered = _slab(o[r0 : r0 + step], d[r0 : r0 + step], boxes)
        out.append(entered & (t_enter * boxes[:, 6] < t_final[r0 : r0 + step, None]))
    return torch.cat(out)


def _tally(tally, kind, needed, live, n, field):
    needed = needed & live[:, None]
    tally.append({
        "kind": kind,
        "pairs": int(needed.sum()),
        "touched": int(needed.any(0).sum()),
        "live": int(live.sum()),
        "rays": int(n),
        "fields": int(field.packed.shape[1]),
        "blocks": int(field.boxes.shape[0]),
    })


def nearest(field: Field, o, d, bound, tally=None):
    """K5's function -> (t [N], packed row [N] int32): the smallest valid
    hit distance below ``bound`` over the blocks the live scan admits, the
    first packed row winning a tie; ``bound`` and -1 where none is."""
    t_best = bound.clone()
    idx = torch.full(bound.shape, -1, dtype=torch.int32, device=bound.device)
    blk, ray, ted = _candidates(o, d, bound, field.boxes)
    t_min, arg = _pair_tests(o, d, field.packed, blk, ray, lambda t, valid, _: torch.min(torch.where(valid, t, INF), 1))
    row = (arg + blk * BLOCK).to(torch.int32)
    for _, s, e in _segments(blk):
        r = ray[s:e]
        tb = t_best[r]
        better = (ted[s:e] < tb) & (t_min[s:e] < tb)
        t_best[r] = torch.where(better, t_min[s:e], tb)
        idx[r] = torch.where(better, row[s:e], idx[r])
    if tally is not None:
        _tally(tally, "nearest", _needed_entered(o, d, t_best, field.boxes), bound > 0, o.shape[0], field)
    return t_best, idx


def occluded(field: Field, o, d, t_cut, excl, tally=None):
    """K6's function -> the final bound [N]: 0 where a valid sphere other
    than packed row ``excl`` hits strictly below the live bound in a block
    the scan admits, else ``t_cut``."""
    t_best = t_cut.clone()
    first = torch.full(t_cut.shape, -1, dtype=torch.int64, device=t_cut.device)
    blk, ray, ted = _candidates(o, d, t_cut, field.boxes)
    cols = torch.arange(BLOCK, device=blk.device)[None, :]

    def hits(t, valid, pairs):
        # an unoccluded ray's live bound is its cut; an occluded one admits
        # no block more
        r = ray[pairs]
        rows = (blk[pairs] * BLOCK)[:, None] + cols
        return ((valid & (t < t_cut[r][:, None]) & (rows != excl[r][:, None].long())).any(1),)

    (hit,) = _pair_tests(o, d, field.packed, blk, ray, hits)
    for b, s, e in _segments(blk):
        r = ray[s:e]
        tb = t_best[r]
        occ = (ted[s:e] < tb) & hit[s:e]
        t_best[r] = torch.where(occ, 0.0, tb)
        if tally is not None:
            first[r] = torch.where(occ & (first[r] < 0), b, first[r])
    if tally is not None:
        needed = _needed_entered(o, d, t_cut, field.boxes) & (first < 0)[:, None]
        hit_rows = torch.nonzero(first >= 0).squeeze(1)
        needed[hit_rows, first[hit_rows]] = True
        _tally(tally, "occluded", needed, t_cut > 0, o.shape[0], field)
    return t_best


# ------------------------------------------------------------ the trace
@dataclasses.dataclass(frozen=True)
class Hit:
    t: torch.Tensor
    obj: torch.Tensor
    position: torch.Tensor
    normal: torch.Tensor
    tangent: torch.Tensor
    binormal: torch.Tensor
    view: torch.Tensor


def _planes(field, o, d):
    n, c = field.plane_nrow[:, :3], field.plane_nrow[:, 3]

    def rows(a):
        return a[:, 0:1] * n[:, 0] + a[:, 1:2] * n[:, 1] + a[:, 2:3] * n[:, 2]

    denom = rows(d)
    onum = rows(o) + c[None, :]
    t_loc = -onum / torch.where(denom == 0, 1.0, denom)
    t = t_loc * field.plane_det[None, :]
    valid = (denom.abs() >= FLT_EPSILON) & (t_loc >= 0) & (t >= 0)
    return torch.where(valid, t, INF)


def _tangent(n):
    zero = torch.zeros_like(n[..., 0])
    smallest = torch.minimum(n[..., 2], torch.minimum(n[..., 0], n[..., 1]))
    tx = torch.stack([zero, -n[..., 2], n[..., 1]], -1)
    ty = torch.stack([-n[..., 2], zero, n[..., 0]], -1)
    tz = torch.stack([-n[..., 1], n[..., 0], zero], -1)
    t = torch.where((n[..., 0] == smallest)[..., None], tx, torch.where((n[..., 1] == smallest)[..., None], ty, tz))
    norm2 = torch.sum(t * t, -1, keepdim=True)
    flat = (n[..., 1].abs() < 0.9)[..., None]
    up = torch.where(flat, n.new_tensor([0.0, 1.0, 0.0]), n.new_tensor([1.0, 0.0, 0.0]))
    t = torch.where(norm2 < 1e-12, torch.linalg.cross(n, up.expand(n.shape)), t)
    return safe_normalize(t)


def trace(field: Field, o, d, tally=None) -> Hit:
    """The nearest hit over the plane (dense) and the spheres (K5, bounded
    by the plane's hit; the plane wins a tie)."""
    num_p = field.plane_nrow.shape[0]
    num_s = field.sphere_center.shape[0]
    t_pl, pidx = torch.min(_planes(field, o, d), dim=1)
    bound = torch.clamp_max(t_pl.to(o.dtype), BIG)
    t_s, row = nearest(field, o.contiguous(), d.contiguous(), bound.contiguous(), tally)
    found = row >= 0
    sidx_best = torch.where(found, field.perm[row.clamp_min(0).long()], -1)
    t_sph = torch.where(found, t_s, INF)
    sphere_wins = t_sph < t_pl
    obj = torch.where(sphere_wins, num_p + sidx_best, pidx)
    t = torch.where(sphere_wins, t_sph, t_pl)
    hit = torch.isfinite(t)
    is_sphere = obj >= num_p
    sidx = torch.clamp(obj - num_p, 0, num_s - 1)
    hit_pos = o + d * torch.where(hit, t, 0.0)[:, None]
    n_sph = safe_normalize(hit_pos - field.sphere_center[sidx])
    t_sph = _tangent(n_sph)
    pidx = torch.clamp(obj, 0, num_p - 1)
    n_pl, tg_pl = field.plane_normal[pidx], field.plane_tangent[pidx]
    normal = torch.where(is_sphere[:, None], n_sph, n_pl)
    tangent = torch.where(is_sphere[:, None], t_sph, tg_pl)
    binormal = torch.linalg.cross(normal, tangent)
    h3 = hit[:, None]
    return Hit(
        t=torch.where(hit, t, INF),
        obj=torch.where(hit, obj, -1),
        position=o + d * torch.where(hit, t, 0.0)[:, None],
        normal=torch.where(h3, normal, 0.0),
        tangent=torch.where(h3, tangent, 0.0),
        binormal=torch.where(h3, binormal, 0.0),
        view=d,
    )


def light_visible(field: Field, o, d, center, radius, lobj, needed, tally=None):
    """NEE visibility on a rigid streamed field: the light's own hit t in
    closed form, no plane at or below it, and no other sphere strictly
    below it (K6, the light's packed row excluded)."""
    c = center[:, :, None]
    ocol, dcol, d_dot_o, o2 = _ray_terms(o, d)
    t_l, valid_l = _quadratic(c[:, 0], c[:, 1], c[:, 2], (radius * radius)[:, None], ocol, dcol, d_dot_o, o2)
    t_l, valid_l = t_l[:, 0], valid_l[:, 0]
    t_pl = torch.min(_planes(field, o, d), dim=1).values
    plane_occ = t_pl <= t_l
    num_p = field.plane_nrow.shape[0]
    num_s = field.sphere_center.shape[0]
    excl = field.inv_perm[torch.clamp(lobj - num_p, 0, num_s - 1)]
    t_cut = torch.where(valid_l, torch.minimum(t_l, t_pl), 0.0)
    t_cut = torch.where(needed, t_cut, 0.0)
    tc = torch.clamp(t_cut.to(o.dtype), 0.0, BIG).contiguous()
    out = occluded(field, o.contiguous(), d.contiguous(), tc, excl.to(torch.int32).contiguous(), tally)
    return valid_l & ~plane_occ & ~(out == 0.0)


# ------------------------------------------------------ the wavefront
def _camera_ray(field, lane, pix, sample, seed, width, height, grid):
    dt = field.origin.dtype
    px = (pix % width).to(dt)
    py = (pix // width).to(dt)
    gx = (sample % grid).to(dt)
    gy = (sample // grid).to(dt)
    u1, u2, _, _ = uniforms4(lane, sample, CAMERA_SALT, seed, dt)
    sx = (px + (gx + u1) / grid) / width
    sy = ((height - py) + (gy + u2) / grid) / height
    d = field.p1[None, :] + field.du[None, :] * sx[:, None] + field.dv[None, :] * sy[:, None] - field.origin[None, :]
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return field.origin.expand(d.shape), d


def _nee_all(field, hit, mat, u_l, m_lambert, m_phong, eps, tally):
    num_l = field.light_obj.shape[0]
    n = hit.position.shape[0]
    pos = hit.position[:, None, :]
    center = field.light_center[None, :, :]
    radius = field.light_radius[None, :]
    dir_l, pdf_l = _light_sample(u_l[0], u_l[1], u_l[2], center, radius, pos)
    not_self = hit.obj[:, None] != field.light_obj[None, :]
    normal = hit.normal[:, None, :]
    view = hit.view[:, None, :]
    exp = mat["specular_exponent"][:, None]
    pdf_b = torch.where(
        m_lambert[:, None],
        _lambert_pdf(normal, dir_l),
        torch.where(m_phong[:, None], _phong_pdf(view, normal, dir_l, exp), 0.0),
    )
    fcos = torch.where(
        m_lambert[:, None, None],
        _lambert_eval_cos(mat["diffuse"][:, None, :], normal, dir_l),
        torch.where(m_phong[:, None, None], _phong_eval_cos(mat["specular"][:, None, :], view, normal, dir_l, exp), 0.0),
    )
    needed = not_self & (pdf_b != 0) & (pdf_l > 0) & (m_lambert | m_phong)[:, None]
    visible = light_visible(
        field,
        (pos + dir_l * eps).reshape(n * num_l, 3),
        dir_l.reshape(n * num_l, 3),
        center.expand(n, num_l, 3).reshape(n * num_l, 3),
        radius.expand(n, num_l).reshape(n * num_l),
        field.light_obj[None, :].expand(n, num_l).reshape(n * num_l),
        needed.reshape(n * num_l),
        tally,
    ).reshape(n, num_l)
    ok = visible & not_self & (pdf_b != 0) & (pdf_l > 0)
    weight = torch.where(ok, 1.0 / (pdf_b + pdf_l), 0.0)
    return torch.sum(weight[..., None] * fcos * field.light_emission[None, :, :3], 1)


def _nee_one(field, hit, mat, u_sel, u3, m_lambert, m_phong, eps, tally):
    num_l = field.light_obj.shape[0]
    li = torch.clamp_max((u_sel * num_l).to(torch.int64), num_l - 1)
    center = field.light_center[li]
    radius = field.light_radius[li]
    lobj = field.light_obj[li]
    emission = field.light_emission[li, :3]
    pos = hit.position
    dir_l, pdf_l = _light_sample(u3[0], u3[1], u3[2], center, radius, pos)
    not_self = hit.obj != lobj
    exp = mat["specular_exponent"]
    pdf_b = torch.where(
        m_lambert,
        _lambert_pdf(hit.normal, dir_l),
        torch.where(m_phong, _phong_pdf(hit.view, hit.normal, dir_l, exp), 0.0),
    )
    fcos = torch.where(
        m_lambert[:, None],
        _lambert_eval_cos(mat["diffuse"], hit.normal, dir_l),
        torch.where(m_phong[:, None], _phong_eval_cos(mat["specular"], hit.view, hit.normal, dir_l, exp), 0.0),
    )
    needed = not_self & (pdf_b != 0) & (pdf_l > 0) & (m_lambert | m_phong)
    visible = light_visible(field, pos + dir_l * eps, dir_l, center, radius, lobj, needed, tally)
    ok = visible & not_self & (pdf_b != 0) & (pdf_l > 0)
    weight = torch.where(ok, num_l / (pdf_b + pdf_l), 0.0)
    return weight[:, None] * fcos * emission


def _light_pdf_for_hit(field, hit_obj, prev_obj, prev_pos):
    is_light = hit_obj[:, None] == field.light_obj[None, :]
    not_self = prev_obj[:, None] != field.light_obj[None, :]
    pdf = 1.0 / _solid_angle(field.light_center[None, :, :], field.light_radius[None, :], prev_pos[:, None, :])
    return torch.sum(torch.where(is_light & not_self, pdf, 0.0), 1)


def render_lanes(field: Field, lane, pix, s_lo, s_hi, seed, width, height, grid, est: Estimator, tally=None):
    """The regenerating wavefront over the lanes ``lane`` (pixel ``pix``,
    samples [s_lo, s_hi)) until each has taken its samples -> radiance sums
    [N, 3] in the arithmetic's type."""
    n = lane.shape[0]
    dev = lane.device
    dt = field.origin.dtype
    num_lights = field.light_obj.shape[0]
    eps = est.surface_epsilon
    mat3 = field.mat
    bg = field.background[:3]
    emit_after_scatter = (not est.direct_lighting) or est.full_mis
    o, d = _camera_ray(field, lane, pix, s_lo, seed, width, height, grid)
    sample = s_lo
    depth = torch.zeros(n, dtype=torch.int64, device=dev)
    throughput = torch.ones((n, 3), dtype=dt, device=dev)
    radiance = torch.zeros((n, 3), dtype=dt, device=dev)
    r_cur = torch.zeros((n, 3), dtype=dt, device=dev)
    emit = torch.ones(n, dtype=torch.bool, device=dev)
    mis_pending = torch.zeros(n, dtype=torch.bool, device=dev)
    pend_pdf_b = torch.ones(n, dtype=dt, device=dev)
    pend_fcos = torch.ones((n, 3), dtype=dt, device=dev)
    pend_delta = torch.zeros(n, dtype=torch.bool, device=dev)
    prev_obj = torch.full((n,), -1, dtype=torch.int64, device=dev)
    prev_pos = torch.zeros((n, 3), dtype=dt, device=dev)
    n_uni = max(5 + 3 * num_lights, 9 if est.one_light_nee else 0)
    ncalls = -(-n_uni // 4)

    while bool((sample < s_hi).any()):
        active = sample < s_hi
        salt0 = depth * ncalls
        us = []
        for i in range(ncalls):
            us.extend(uniforms4(lane, sample, salt0 + i, seed, dt))

        hit = trace(field, o, d, tally)
        was_hit = hit.obj >= 0
        t = throughput
        r = r_cur

        pdf_l_vis = _light_pdf_for_hit(field, hit.obj, prev_obj, prev_pos)
        if est.full_mis:
            pdf_l_vis = torch.where(pend_delta, 0.0, pdf_l_vis)
        denom = pdf_l_vis + pend_pdf_b
        weight = pend_fcos / torch.where(denom == 0, 1.0, denom)[:, None]
        t = torch.where((mis_pending & active)[:, None], t * weight, t)

        miss = active & ~was_hit
        r = r + torch.where(miss[:, None], t * bg[None, :], 0.0)
        on_path = active & was_hit
        obj = torch.clamp_min(hit.obj, 0)
        mat = {k: v[obj] for k, v in mat3.items()}

        p_rr = torch.max(torch.maximum(torch.maximum(mat["diffuse"], mat["specular"]), mat["transparency"]), -1).values
        cont, prob_rr = _flip_coin(us[0], p_rr)
        t = torch.where(on_path[:, None], t / prob_rr[:, None], t)
        t_kill = t
        emitter = on_path & emit
        survive = on_path & cont & (depth < est.max_depth)

        sum_d = torch.sum(mat["diffuse"], -1)
        sum_s = torch.sum(mat["specular"], -1)
        sum_t = torch.sum(mat["transparency"], -1)
        total = sum_d + sum_s + sum_t
        p_t = torch.where(total > 0, sum_t / torch.where(total == 0, 1.0, total), 0.0)
        transmit, prob_t = _flip_coin(us[1], p_t)
        t = torch.where(survive[:, None], t / prob_t[:, None], t)
        ds = sum_d + sum_s
        p_d = torch.where(ds > 0, sum_d / torch.where(ds == 0, 1.0, ds), 0.0)
        diff, prob_d = _flip_coin(us[2], p_d)
        t = torch.where((survive & ~transmit)[:, None], t / prob_d[:, None], t)

        m_transmit = survive & transmit
        m_lambert = survive & ~transmit & diff
        m_phong = survive & ~transmit & ~diff & (mat["specular_exponent"] > 0)
        m_mirror = survive & ~transmit & ~diff & (mat["specular_exponent"] <= 0)
        scatter = m_lambert | m_phong | m_mirror

        if est.direct_lighting and num_lights:
            if est.one_light_nee and num_lights > 1:
                nee = _nee_one(field, hit, mat, us[5], (us[6], us[7], us[8]), m_lambert, m_phong, eps, tally)
            else:
                u_l = torch.stack(us[5 : 5 + 3 * num_lights]).reshape(3, num_lights, n).permute(0, 2, 1)
                nee = _nee_all(field, hit, mat, u_l, m_lambert, m_phong, eps, tally)
            r = r + torch.where(scatter[:, None], t * nee, 0.0)

        d_trans = _transmission_sample(hit.view, hit.normal, mat["refractive_index"])
        d_lam, pdf_lam = _lambert_sample(us[3], us[4], hit.tangent, hit.binormal, hit.normal)
        d_ph, pdf_ph = _phong_sample(us[3], us[4], hit.view, hit.normal, mat["specular_exponent"])
        d_mir = _reflect(hit.view, hit.normal)
        new_d = torch.where(
            m_transmit[:, None],
            d_trans,
            torch.where(m_lambert[:, None], d_lam, torch.where(m_phong[:, None], d_ph, d_mir)),
        )
        pdf_b = torch.where(m_lambert, pdf_lam, torch.where(m_phong, pdf_ph, 1.0))
        fcos = torch.where(
            m_transmit[:, None],
            mat["specular"].expand(d_trans.shape[:-1] + (3,)),
            torch.where(
                m_lambert[:, None],
                _lambert_eval_cos(mat["diffuse"], hit.normal, d_lam),
                torch.where(
                    m_phong[:, None],
                    _phong_eval_cos(mat["specular"], hit.view, hit.normal, d_ph, mat["specular_exponent"]),
                    torch.where(_dot(hit.normal, d_mir) > 0, mat["specular"], 0.0),
                ),
            ),
        )

        t = torch.where(m_transmit[:, None], t * fcos, t)
        r = r + torch.where(emitter[:, None], torch.where(survive[:, None], t, t_kill) * mat["emission"], 0.0)
        continuing = survive & (m_transmit | (pdf_b != 0))
        if est.regen_threshold > 0.0:
            continuing = continuing & (torch.max(t, -1).values >= est.regen_threshold)

        path_end = active & ~continuing
        new_sample = torch.where(path_end, sample + 1, sample)
        o_cam, d_cam = _camera_ray(field, lane, pix, torch.minimum(new_sample, s_hi - 1), seed, width, height, grid)
        cont3, end3 = continuing[:, None], path_end[:, None]
        sc = scatter & ~path_end
        sample = new_sample
        depth = torch.where(path_end, 0, depth + 1)
        o = torch.where(cont3, hit.position + new_d * eps, torch.where(end3, o_cam, o))
        d = torch.where(cont3, new_d, torch.where(end3, d_cam, d))
        throughput = torch.where(end3, 1.0, t)
        radiance = radiance + torch.where(end3, r, 0.0)
        r_cur = torch.where(end3, 0.0, r)
        emit = path_end | torch.where(scatter, emit_after_scatter, emit)
        mis_pending = ~path_end & scatter
        pend_pdf_b = torch.where(sc, pdf_b, 1.0)
        pend_fcos = torch.where(sc[:, None], fcos, 1.0)
        pend_delta = m_mirror & ~path_end
        prev_obj = torch.where(sc, hit.obj, -1)
        prev_pos = torch.where(sc[:, None], hit.position, 0.0)
    return radiance


# ------------------------------------------------------ lanes and images
def tiled_pixel_order(width: int, height: int) -> np.ndarray:
    """Lane -> pixel id, walking the image in 64x64 screen tiles."""
    ts = TILE_TS
    xs, ys = np.meshgrid(np.arange(width), np.arange(height))
    tiles_x = -(-width // ts)
    tile_id = (ys // ts) * tiles_x + (xs // ts)
    within = (ys % ts) * ts + (xs % ts)
    return np.argsort((tile_id * (ts * ts) + within).ravel(), kind="stable").astype(np.uint32)


def n_tiles(width: int, height: int) -> int:
    return -(-width // TILE_TS) * -(-height // TILE_TS)


def tile_pixels(width: int, height: int, tiles) -> np.ndarray:
    """The pixel ids of the screen tiles ``tiles`` in lane order (tiles in
    ascending order, row-major inside each) -> int64 [n_px]."""
    pixmap = tiled_pixel_order(width, height).astype(np.int64)
    tiles_x = -(-width // TILE_TS)
    tile = (pixmap // width // TILE_TS) * tiles_x + (pixmap % width) // TILE_TS
    return pixmap[np.isin(tile, np.asarray(sorted(tiles), np.int64))]


def pixel_lanes(width: int, height: int, pixels) -> np.ndarray:
    """The first-sample lanes (lane mod W*H) that render ``pixels``, in lane
    order -> int64."""
    pixmap = tiled_pixel_order(width, height).astype(np.int64)
    return np.nonzero(np.isin(pixmap, np.asarray(pixels, np.int64)))[0]


def pass_pixels(field: Field, seed: int, width: int, height: int, spp: int, est: Estimator, lanes=None,
                tally=None) -> torch.Tensor:
    """One pass with u32 pass seed ``seed`` -> [n_px, 4] float32: every
    pixel in image order (``lanes`` None), or the pixels of the first-sample
    lanes ``lanes`` (int64, ascending, < W*H) in their order, each rendered
    by all of its lanes."""
    dev = field.origin.device
    grid = max(int(spp**0.5), 1)
    eff = grid * grid
    divisor = float(spp if est.kajo_spp_quirk else eff)
    n = width * height
    mult = next((m for m in (LANE_MULT, 2) if eff % m == 0), 1)
    pixmap = torch.from_numpy(tiled_pixel_order(width, height).astype(np.int64)).to(dev)
    base = torch.arange(n, dtype=torch.int64, device=dev) if lanes is None else torch.as_tensor(lanes, device=dev)
    lane = torch.cat([base + k * n for k in range(mult)])
    k = eff // mult
    s_lo = (lane // n) * k
    seed_t = torch.tensor(seed & 0xFFFFFFFF, dtype=torch.int64, device=dev)
    rgb = render_lanes(field, lane, pixmap[lane % n], s_lo, s_lo + k, seed_t, width, height, grid, est, tally)
    rgb = rgb.reshape(mult, -1, 3).sum(0)
    if lanes is None:
        rgb = torch.zeros_like(rgb).index_copy_(0, pixmap, rgb)
    rgb = rgb.to(torch.float32)
    return torch.cat([rgb / divisor, torch.ones((rgb.shape[0], 1), dtype=torch.float32, device=dev)], 1)


def render_batch(field: Field, seed: int, first_pass: int, n_passes: int, width: int, height: int, spp: int,
                 est: Estimator, lanes=None) -> torch.Tensor:
    """The sum of passes ``first_pass`` .. ``first_pass + n_passes - 1`` of a
    render seeded with ``seed`` (pass p's seed ``pass_seed(seed, p)``),
    added in pass order -> [n_px, 4] float32 (see :func:`pass_pixels`)."""
    n_px = width * height if lanes is None else len(lanes)
    total = torch.zeros((n_px, 4), dtype=torch.float32, device=field.origin.device)
    for i in range(n_passes):
        total += pass_pixels(field, pass_seed(seed, first_pass + i), width, height, spp, est, lanes)
    return total
