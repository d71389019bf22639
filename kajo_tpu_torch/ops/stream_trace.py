"""Streaming sphere trace for big scenes: K5 (nearest hit) and K6 (any-hit
occlusion), hand-written CUDA kernels and their plain PyTorch versions.

Port of the V4 path of ``kajo_tpu/ops/pallas/stream_trace.py``
(``_build_kernel_v4``, reached through ``_v4_impl`` with ``occl=False`` for
K5 and ``occl=True`` for K6) and of its host side: ``morton_order``,
``build_stream_scene``, ``nearest_sphere``, ``occluded_sphere``.

``build_stream_scene`` sorts the spheres along a 3D Morton curve, packs them
as rigid 4-float records (cx, cy, cz, r²) or general 14-float records (inv3
row-major, invt, r², det), and cuts the packed array into 128-sphere blocks,
each with an AABB (inflated by ``slack``) and the block's minimum det in
slot 6. Whole blocks are then ordered front to back from the camera. The
kernels and their plain versions scan the blocks in this packed order,
skip a block whose box a ray does not enter below its live bound, and keep
a strict ``t < t_best``, so the first packed index wins a tie; they report
packed indices, which ``nearest_sphere`` maps back to scene numbering
through the padded ``perm``.

The wrappers dispatch on the device of the rays: CPU tensors take the plain
version, CUDA tensors launch the kernel (``csrc/stream_trace.cu``) or raise.
Nothing falls back from CUDA to the plain version. ``nearest_launches`` and
``occluded_launches`` count the kernels' launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .sampling import sqrt_f32

BIG = float(np.float32(3.0e38))
BLOCK = 128     # spheres per block: one AABB each, one CTA-wide scan in the kernel
F_RIGID = 4     # cx, cy, cz, r2
F_GENERAL = 14  # inv3 row-major (9), invt (3), r2, det
# elements of one [rays, blocks] box-test intermediate of the plain versions
_PLAIN_CHUNK_ELEMS = 1 << 26

nearest_launches = 0
occluded_launches = 0


# ------------------------------------------------------ sphere quadratics
def _safe_sqrt(x):
    return sqrt_f32(torch.clamp_min(x, 0.0))


def ray_terms(o, d):
    """The ray arguments of :func:`quadratic_rigid` for rays [N, 3] ->
    (o columns, d columns, d·o, o·o), each column and sum [N, 1], the sums
    taken left to right as the CUDA kernel takes them."""
    ocol, dcol = columns(o), columns(d)
    d_dot_o = dcol[0] * ocol[0] + dcol[1] * ocol[1] + dcol[2] * ocol[2]
    o2 = ocol[0] * ocol[0] + ocol[1] * ocol[1] + ocol[2] * ocol[2]
    return ocol, dcol, d_dot_o, o2


def columns(x):
    """[N, k] -> k columns [N, 1], which broadcast against [S] fields."""
    return tuple(x[:, i : i + 1] for i in range(x.shape[1]))


def quadratic_rigid(cx, cy, cz, r2, o, d, d_dot_o, o2):
    """World-space stable quadratic with a == 1 (|d| == 1) -> (t, valid).
    ``o``/``d`` are per-axis component triples; sums run left to right, as
    in the CUDA kernel."""
    d_dot_c = d[0] * cx + d[1] * cy + d[2] * cz
    o_dot_c = o[0] * cx + o[1] * cy + o[2] * cz
    b = 2.0 * (d_dot_o - d_dot_c)
    cq = o2 - 2.0 * o_dot_c + (cx * cx + cy * cy + cz * cz - r2)
    discr = b * b - 4.0 * cq
    sq = _safe_sqrt(discr)
    q = torch.where(b < 0, (-b - sq) * 0.5, (-b + sq) * 0.5)
    t1 = cq / torch.where(q == 0, 1.0, q)
    lo = torch.minimum(q, t1)
    hi = torch.maximum(q, t1)
    t = torch.where(lo < 0, hi, lo)
    valid = (discr >= 0) & (hi >= 0) & (q != 0) & (t >= 0)
    return t, valid


def object_ray(rec, o, d):
    """A ray in the object space of a general record (``rec``: its 14
    fields, inv3 row-major, invt, r2, det) -> (o_loc, d_loc), each a triple
    of components; the sums run left to right, as in the CUDA kernel."""
    o_loc = tuple(rec[3 * i] * o[0] + rec[3 * i + 1] * o[1] + rec[3 * i + 2] * o[2] + rec[9 + i] for i in range(3))
    d_loc = tuple(rec[3 * i] * d[0] + rec[3 * i + 1] * d[1] + rec[3 * i + 2] * d[2] for i in range(3))
    return o_loc, d_loc


def quadratic_general(rec, o, d):
    """Object-space stable quadratic with det-scaled t -> (t, valid, t_loc).
    ``rec``: the 14 fields of a general record (inv3, invt, r2, det);
    ``o``/``d``: per-axis component triples."""
    (ox, oy, oz), (dx, dy, dz) = object_ray(rec, o, d)
    r2, det = rec[12], rec[13]
    a = dx * dx + dy * dy + dz * dz
    b = 2.0 * (dx * ox + dy * oy + dz * oz)
    cq = ox * ox + oy * oy + oz * oz - r2
    discr = b * b - 4.0 * a * cq
    sq = _safe_sqrt(discr)
    q = torch.where(b < 0, (-b - sq) * 0.5, (-b + sq) * 0.5)
    t0 = q / torch.where(a == 0, 1.0, a)
    t1 = cq / torch.where(q == 0, 1.0, q)
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    t_loc = torch.where(lo < 0, hi, lo)
    t = t_loc * det
    valid = (discr >= 0) & (hi >= 0) & (a != 0) & (q != 0) & (t >= 0)
    return t, valid, t_loc


# ------------------------------------------------------------ packing
def general_records(prep):
    """The spheres' general records [S, 14]: inv3 row-major, invt, r2, det."""
    s = prep.sphere_inv3.shape[0]
    return torch.cat(
        [prep.sphere_inv3.reshape(s, 9), prep.sphere_invt, prep.sphere_radius2[:, None], prep.sphere_det[:, None]], 1
    )


def _expand_bits10(v):
    """Spread the low 10 bits of each value two positions apart (LBVH
    morton3D dilation). In int64: no product overflows, and each mask keeps
    only bits below 32, so u32 wraparound changes nothing."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_order(centers: torch.Tensor) -> torch.Tensor:
    """Permutation sorting sphere centers along a 3D Morton curve (stable
    among equal codes)."""
    lo = torch.min(centers, 0).values
    hi = torch.max(centers, 0).values
    q = (centers - lo) / torch.clamp_min(hi - lo, 1e-20)
    q = torch.clamp(q * 1023.0, 0.0, 1023.0).to(torch.int64)
    code = (_expand_bits10(q[:, 0]) << 2) | (_expand_bits10(q[:, 1]) << 1) | _expand_bits10(q[:, 2])
    return torch.argsort(code, stable=True)


def build_stream_scene(prep):
    """Morton-sorted packed spheres and per-block AABBs for K5/K6 ->
    (packed [S_pad, 4|14], boxes [S_pad/128, 8], perm [S_pad] int64,
    inv_perm [S] int32).

    ``perm`` maps a packed row to its sphere, ``inv_perm`` a sphere to its
    packed row. Pad rows are unhittable (r² = -1), their ``perm`` entries
    map to sphere 0, and ``inv_perm`` never points at them. Box slots: lo
    (3), hi (3), the block's min det clamped at 0 (det-scaled hit distances
    can be below the world distance; t_enter times min det bounds them from
    below; 1 for rigid scenes), 0. The boxes are inflated by 1e-4 x (scene
    extent + 1) so f32 rounding in the slab test never culls a true hit. Whole blocks are ordered by their squared
    distance from the camera, nearest first, so primary and near-surface
    rays tighten their bound on the first blocks they visit."""
    rigid = prep.rigid
    s = prep.sphere_center.shape[0]
    dev = prep.sphere_center.device
    perm = morton_order(prep.sphere_center)
    radius = _safe_sqrt(prep.sphere_radius2)
    if rigid:
        packed = torch.cat([prep.sphere_center, prep.sphere_radius2[:, None]], 1)[perm]
        ext = radius[perm][:, None].expand(s, 3)
    else:
        packed = general_records(prep)[perm]
        # world extent of a transformed sphere x = c + M u, |u| = r, along
        # axis a: r * |row_a(M)|
        row_norm = sqrt_f32(torch.sum(prep.sphere_fwd3 * prep.sphere_fwd3, 2))
        ext = (radius[:, None] * row_norm)[perm]
    centers = prep.sphere_center[perm]
    s_pad = -(-max(s, 1) // BLOCK) * BLOCK
    pad = s_pad - s
    pad_rows = torch.zeros((pad, packed.shape[1]), dtype=torch.float32, device=dev)
    pad_rows[:, -1 if rigid else -2] = -1.0  # r2 = -1: unhittable
    packed = torch.cat([packed, pad_rows])
    # pad spheres reuse the last real center so they never widen a box
    last_c = centers[-1:] if s else torch.zeros((1, 3), dtype=torch.float32, device=dev)
    centers = torch.cat([centers, last_c.expand(pad, 3)])
    ext = torch.cat([ext, torch.zeros((pad, 3), dtype=torch.float32, device=dev)])
    dets = torch.ones(s, dtype=torch.float32, device=dev) if rigid else torch.clamp_min(prep.sphere_det, 0.0)[perm]
    dets = torch.cat([dets, torch.full((pad,), BIG, dtype=torch.float32, device=dev)])

    n_blocks = s_pad // BLOCK
    lo = torch.min((centers - ext).reshape(n_blocks, BLOCK, 3), 1).values
    hi = torch.max((centers + ext).reshape(n_blocks, BLOCK, 3), 1).values
    mind = torch.min(dets.reshape(n_blocks, BLOCK), 1).values[:, None]
    slack = 1e-4 * (torch.max(hi) - torch.min(lo) + 1.0)
    boxes = torch.cat([lo - slack, hi + slack, mind, torch.zeros((n_blocks, 1), dtype=torch.float32, device=dev)], 1)
    perm = torch.cat([perm, torch.zeros((pad,), dtype=perm.dtype, device=dev)])
    rows = torch.arange(s_pad, device=dev)  # packed row before the block order
    if n_blocks > 1:
        cam = prep.camera.origin
        gap = torch.clamp_min(lo - cam[None, :], 0.0) + torch.clamp_min(cam[None, :] - hi, 0.0)
        order = torch.argsort(torch.sum(gap * gap, 1), stable=True)
        packed = packed.reshape(n_blocks, BLOCK, -1)[order].reshape(s_pad, -1)
        boxes = boxes[order]
        perm = perm.reshape(n_blocks, BLOCK)[order].reshape(s_pad)
        rows = rows.reshape(n_blocks, BLOCK)[order].reshape(s_pad)
    # pad rows (the last s_pad - s before the block order) scatter into a
    # slot past the end, which is dropped
    inv_perm = torch.zeros(s + 1, dtype=torch.int32, device=dev)
    inv_perm[torch.where(rows < s, perm, s)] = torch.arange(s_pad, dtype=torch.int32, device=dev)
    return packed.contiguous(), boxes.contiguous(), perm.contiguous(), inv_perm[:s].contiguous()


# -------------------------------------------------- plain PyTorch versions
def _slab(o, d, boxes):
    """Every ray against every block's box -> (t_enter [N, B], entered
    [N, B]): the kernel's slab test, the same float operations (BIG, not
    inf, so that 0 * (1/d) stays 0 on a face; fmin/fmax as the kernel's
    fminf/fmaxf)."""
    inv = torch.where(d == 0, BIG, 1.0 / torch.where(d == 0, 1.0, d))
    t_enter = torch.zeros((o.shape[0], boxes.shape[0]), dtype=torch.float32, device=o.device)
    t_exit = torch.full_like(t_enter, BIG)
    for ax in range(3):
        oa, da, ia = o[:, ax : ax + 1], d[:, ax : ax + 1], inv[:, ax : ax + 1]
        lo, hi = boxes[:, ax], boxes[:, 3 + ax]
        inside = (oa >= lo) & (oa <= hi)
        t0 = (lo - oa) * ia
        t1 = (hi - oa) * ia
        near = torch.where(da == 0, torch.where(inside, -BIG, BIG), torch.fmin(t0, t1))
        far = torch.where(da == 0, torch.where(inside, BIG, -BIG), torch.fmax(t0, t1))
        t_enter = torch.fmax(t_enter, near)
        t_exit = torch.fmin(t_exit, far)
    return t_enter, t_exit >= t_enter


def _block_scan(rigid, o, d, packed, boxes, visit):
    """Visit the 128-sphere blocks in packed order, as the kernel does, one
    chunk of rays at a time: visit(rays, block, t [n, 128], valid [n, 128],
    entered [n], t_enter_det [n]) for the chunk's slice ``rays``, where a
    ray may scan the block if it ``entered`` the box and ``t_enter_det``
    (t_enter times the block's min det) is below its live bound."""
    n = o.shape[0]
    n_blocks = boxes.shape[0]
    # a chunk's [rays, blocks] box tests stay within _PLAIN_CHUNK_ELEMS
    step = max(1, _PLAIN_CHUNK_ELEMS // max(n_blocks, 1))
    for r0 in range(0, n, step):
        oc, dc = o[r0 : r0 + step], d[r0 : r0 + step]
        t_enter, entered = _slab(oc, dc, boxes)
        ocol, dcol, d_dot_o, o2 = ray_terms(oc, dc)
        for blk in range(n_blocks):
            rec = packed[blk * BLOCK : (blk + 1) * BLOCK].T
            if rigid:
                t, valid = quadratic_rigid(rec[0], rec[1], rec[2], rec[3], ocol, dcol, d_dot_o, o2)
            else:
                t, valid, _ = quadratic_general(rec, ocol, dcol)
            visit(slice(r0, r0 + oc.shape[0]), blk, t, valid, entered[:, blk], t_enter[:, blk] * boxes[blk, 6])


def nearest_sphere_plain(rigid: bool, o, d, bound, packed, boxes):
    """K5's function in plain PyTorch -> (t [N] f32, idx [N] int32).

    The kernel's scan: blocks in packed order, a block skipped for a ray
    whose slab test against its live bound fails, a strict ``t < t_best``
    inside (the first packed row wins a tie). ``t`` is the smallest valid
    hit distance below ``bound`` and ``idx`` its packed row; where no
    sphere beats the bound, ``t`` is the bound and ``idx`` -1.

    The box test is conservative for the geometry, and for rays inside or
    near the scene the scan equals the exhaustive one. Far outside the
    scene (origins ~1e4 units away) the quadratic's constant term loses its
    precision (|o|² ~ 1e8 against r² ~ 0.1) and reports hits on spheres the
    ray passes units away from; the box test rejects them, as the kernel
    does, so this version keeps the test rather than scan every sphere."""
    t_best = bound.clone()
    idx = torch.full(bound.shape, -1, dtype=torch.int32, device=bound.device)

    def visit(rays, blk, t, valid, entered, t_enter_det):
        may = entered & (t_enter_det < t_best[rays])
        t_min, arg = torch.min(torch.where(valid, t, float("inf")), 1)
        better = may & (t_min < t_best[rays])
        t_best[rays] = torch.where(better, t_min, t_best[rays])
        idx[rays] = torch.where(better, (arg + blk * BLOCK).to(torch.int32), idx[rays])

    _block_scan(rigid, o, d, packed, boxes, visit)
    return t_best, idx


def occluded_sphere_plain(rigid: bool, o, d, t_cut, excl, packed, boxes):
    """K6's function in plain PyTorch -> the final bound [N] f32: 0 where a
    valid sphere other than packed row ``excl`` hits strictly below the
    bound in a block the ray's box test (against its live bound) admits,
    else ``t_cut`` (so a ray with ``t_cut == 0`` is 0). The scan and its box
    test are :func:`nearest_sphere_plain`'s."""
    t_best = t_cut.clone()

    def visit(rays, blk, t, valid, entered, t_enter_det):
        may = entered & (t_enter_det < t_best[rays])
        rows = torch.arange(blk * BLOCK, (blk + 1) * BLOCK, dtype=torch.int32, device=t.device)
        hit = (valid & (t < t_best[rays][:, None]) & (rows[None, :] != excl[rays][:, None])).any(1)
        t_best[rays] = torch.where(may & hit, 0.0, t_best[rays])

    _block_scan(rigid, o, d, packed, boxes, visit)
    return t_best


# ------------------------------------------------------------------ CUDA
def _check(name, x, dtype, shape):
    if x.device.type != "cuda" or x.dtype != dtype or not x.is_contiguous() or tuple(x.shape) != shape:
        raise ValueError(
            f"{name}: the CUDA stream trace takes a contiguous {dtype} {shape} tensor on a CUDA device, "
            f"got {x.dtype} {tuple(x.shape)} on {x.device}"
        )


def _launch(occl: bool, rigid: bool, o, d, bound, packed, boxes, excl=None):
    from ._nvcc import load_library

    n = o.shape[0]
    fields = F_RIGID if rigid else F_GENERAL
    n_blocks = packed.shape[0] // BLOCK
    _check("o", o, torch.float32, (n, 3))
    _check("d", d, torch.float32, (n, 3))
    _check("bound", bound, torch.float32, (n,))
    _check("packed", packed, torch.float32, (n_blocks * BLOCK, fields))
    _check("boxes", boxes, torch.float32, (n_blocks, 8))
    lib = load_library("stream_trace.cu")
    t_out = torch.empty((n,), dtype=torch.float32, device=o.device)
    if occl:
        _check("excl", excl, torch.int32, (n,))
        fn, last = lib.kajo_stream_occluded, excl
    else:
        idx_out = torch.empty((n,), dtype=torch.int32, device=o.device)
        fn, last = lib.kajo_stream_nearest, idx_out
    # rays o, d, bound; packed, boxes; t_out; idx_out | excl; n, n_blocks, rigid; stream
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        err = fn(o.data_ptr(), d.data_ptr(), bound.data_ptr(), packed.data_ptr(), boxes.data_ptr(),
                 t_out.data_ptr(), last.data_ptr(), n, n_blocks, int(rigid), stream)
    if err != 0:
        raise RuntimeError(f"stream trace launch failed: CUDA error {err}")
    return t_out if occl else (t_out, idx_out)


def launch_nearest(rigid: bool, o, d, bound, packed, boxes):
    """Launch K5 on the current stream -> (t [N], packed idx [N] int32),
    the function of :func:`nearest_sphere_plain`."""
    global nearest_launches
    out = _launch(False, rigid, o, d, bound, packed, boxes)
    nearest_launches += 1
    return out


def launch_occluded(rigid: bool, o, d, t_cut, excl, packed, boxes):
    """Launch K6 on the current stream -> final bound [N], the function of
    :func:`occluded_sphere_plain`."""
    global occluded_launches
    out = _launch(True, rigid, o, d, t_cut, packed, boxes, excl)
    occluded_launches += 1
    return out


# ------------------------------------------------------------- host side
def _device_kind(x):
    kind = x.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no stream trace for device {x.device}")
    return kind


def nearest_sphere(prep, o, d, t_max=None):
    """Streamed nearest-sphere hit for a prepared scene with a stream
    packing -> (t [N] with inf on miss, sphere index [N] in scene numbering,
    -1 on miss). ``t_max`` (per ray, optional) bounds the search."""
    n = o.shape[0]
    bound = o.new_full((n,), BIG) if t_max is None else torch.clamp_max(t_max.to(torch.float32), BIG)
    o, d, bound = o.contiguous(), d.contiguous(), bound.contiguous()
    if _device_kind(o) == "cpu":
        t, idx = nearest_sphere_plain(prep.rigid, o, d, bound, prep.stream_packed, prep.stream_boxes)
    else:
        t, idx = launch_nearest(prep.rigid, o, d, bound, prep.stream_packed, prep.stream_boxes)
    found = idx >= 0
    idx_orig = torch.where(found, prep.stream_perm[idx.clamp_min(0).long()], -1)
    return torch.where(found, t, float("inf")), idx_orig


def occluded_sphere(prep, o, d, t_cut, excl=None):
    """Any-hit occlusion -> bool [N]: True where some sphere's hit t is
    strictly below ``t_cut``, skipping the packed row ``excl`` (int32 per
    ray, -1 = none). A ray with ``t_cut <= 0`` reports occluded at no cost."""
    n = o.shape[0]
    tc = torch.clamp(t_cut.to(torch.float32), 0.0, BIG).contiguous()
    if excl is None:
        excl = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    excl = excl.to(torch.int32).contiguous()
    o, d = o.contiguous(), d.contiguous()
    if _device_kind(o) == "cpu":
        out = occluded_sphere_plain(prep.rigid, o, d, tc, excl, prep.stream_packed, prep.stream_boxes)
    else:
        out = launch_occluded(prep.rigid, o, d, tc, excl, prep.stream_packed, prep.stream_boxes)
    return out == 0.0
