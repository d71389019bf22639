"""Streaming sphere trace for big scenes: K5 (nearest hit) and K6 (any-hit
occlusion), and the nearest-hit designs K7 (V1), K8 (V2) and K9 (V3),
hand-written CUDA kernels and their plain PyTorch versions.

Port of ``kajo_tpu/ops/pallas/stream_trace.py``: its V4 path
(``_build_kernel_v4``, reached through ``_v4_impl`` with ``occl=False`` for
K5 and ``occl=True`` for K6), its V1, V2 and V3 kernels (``_build_kernel``,
``_build_kernel_v2``, ``_build_kernel_v3``) with their host-side lists, and
its host side: ``morton_order``, ``build_stream_scene``, ``nearest_sphere``,
``occluded_sphere``.

``build_stream_scene`` sorts the spheres along a 3D Morton curve, packs them
as rigid 4-float records (cx, cy, cz, r²) or general 14-float records (inv3
row-major, invt, r², det), and cuts the packed array into 128-sphere blocks,
each with an AABB (inflated by ``slack``) and the block's minimum det in
slot 6. Whole blocks are then ordered front to back from the camera. K5/K6
and their plain versions scan the blocks in this packed order, skip a block
whose box a ray does not enter below its live bound, and keep a strict
``t < t_best``, so the first packed index wins a tie; they report packed
indices, which ``nearest_sphere`` maps back to scene numbering through the
padded ``perm``. K5 and K6 give each ray eight lanes of a warp, let a
warp decide a block for its four rays, and test the superblocks of
``build_stream_scene`` (8 blocks each) before their blocks; K6 stops a
ray at its first occluder and a warp once all its rays are occluded. None
of that changes a ray's answer (the notes in ``csrc/stream_trace.cu`` say
why). ``NEAREST_DESIGN`` (or ``nearest_design(...)``, or ``design=``)
routes the nearest hit through K7, K8 or K9 instead, which
decide per tile of rays which blocks the whole tile scans (see the section
of the designs below); shadow rays of rigid scenes stay on K6 under every
design, as in kajo_tpu.

The nearest hit's t is differentiable (kajo_tpu's ``_nearest``
``custom_vjp``): :func:`nearest_sphere` wraps whichever design answers in
``_NearestHit``, whose backward (:func:`nearest_vjp`) recomputes each
winner's t from its packed record with the same quadratic and pulls the
cotangent back to the rays and the records, so gradients reach the
spheres' transforms and radii through ``build_stream_scene``. The
occlusion test has no gradient, as in kajo_tpu.

The wrappers dispatch on the device of the rays: CPU tensors take the plain
version, CUDA tensors launch the kernel (``csrc/stream_trace.cu``,
``stream_trace_v1.cu``, ``_v2.cu``, ``_v3.cu``, which share the device
helpers of ``csrc/stream_trace.cuh``) or raise. Nothing falls back from CUDA
to the plain version. ``nearest_launches``, ``occluded_launches`` and
``nearest_v1_launches`` .. ``nearest_v3_launches`` count the kernels'
launches. Not ported: kajo_tpu's ``FRONT_TO_BACK=False`` and
``V4_RAY_ROWS`` A/B knobs.
"""

from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import torch

from .sampling import safe_sqrt, sqrt_f32

BIG = float(np.float32(3.0e38))
BLOCK = 128     # spheres per block: one AABB each, one CTA-wide scan in the kernel
F_RIGID = 4     # cx, cy, cz, r2
F_GENERAL = 14  # inv3 row-major (9), invt (3), r2, det
# elements of one [rays, blocks] box-test intermediate of the plain versions
_PLAIN_CHUNK_ELEMS = 1 << 26

# The nearest-hit design of nearest_sphere (kajo_tpu's KERNEL_V2/V3/V4,
# TILE_FRUSTUM and NEAR_FAR_ORDER flags as one setting): "v4" K5 (the
# default); "v1", "v1-frustum", "v1-near-far" K7 with the packed, frustum or
# near-to-far block order; "v2" K8; "v3" K9 (K7 in packed order on a scene
# whose packed array exceeds V3_RESIDENT_BYTES, as in kajo_tpu).
DESIGNS = ("v4", "v1", "v1-frustum", "v1-near-far", "v2", "v3")
NEAREST_DESIGN = "v4"
V1_TILE = 128  # rays per K7 tile: its CTA (kajo_tpu's V1 tile: 4096)
V2_TILE = 512  # rays per K8 tile (kajo_tpu's V2_RAY_TILE)
V2_SUPER = 1024  # spheres per K8 superblock: 8 blocks (kajo_tpu's V2_SUPER)
V3_TILE = 512  # rays per K9 tile (kajo_tpu's V3_RAY_TILE)
V3_RESIDENT_BYTES = 6 * 2**20  # kajo_tpu's cap on the packed scene for V3

nearest_launches = 0
occluded_launches = 0
nearest_v1_launches = 0
nearest_v2_launches = 0
nearest_v3_launches = 0
# (ray, block) pairs the designs' plain scans test, while counting_scans() is on
_scan_counts = None


# ------------------------------------------------------ sphere quadratics
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


def rigid_const(cx, cy, cz, r2):
    """The rigid quadratic's ray-independent term cx²+cy²+cz²-r²."""
    return cx * cx + cy * cy + cz * cz - r2


def rigid_terms(cx, cy, cz, k, o, d, d_dot_o, o2):
    """The rigid quadratic's (b, constant term, discriminant); ``k`` is
    :func:`rigid_const` of the sphere."""
    d_dot_c = d[0] * cx + d[1] * cy + d[2] * cz
    o_dot_c = o[0] * cx + o[1] * cy + o[2] * cz
    b = 2.0 * (d_dot_o - d_dot_c)
    cq = o2 - 2.0 * o_dot_c + k
    discr = b * b - 4.0 * cq
    return b, cq, discr


def quadratic_rigid(cx, cy, cz, r2, o, d, d_dot_o, o2):
    """World-space stable quadratic with a == 1 (|d| == 1) -> (t, valid).
    ``o``/``d`` are per-axis component triples; sums run left to right, as
    in the CUDA kernel."""
    return rigid_roots(*rigid_terms(cx, cy, cz, rigid_const(cx, cy, cz, r2), o, d, d_dot_o, o2))


def rigid_roots(b, cq, discr):
    """The rigid quadratic's (t, valid) from its terms."""
    # safe_sqrt, not the root of a clamp: 0 where discr <= 0 with a zero
    # gradient, where the clamp's root has an infinite one (0 * inf = NaN in
    # the backward of every sphere a ray misses)
    sq = safe_sqrt(discr)
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


def general_terms(rec, o, d):
    """The general quadratic's (a, b, constant term, discriminant)."""
    (ox, oy, oz), (dx, dy, dz) = object_ray(rec, o, d)
    a = dx * dx + dy * dy + dz * dz
    b = 2.0 * (dx * ox + dy * oy + dz * oz)
    cq = ox * ox + oy * oy + oz * oz - rec[12]
    discr = b * b - 4.0 * a * cq
    return a, b, cq, discr


def quadratic_general(rec, o, d):
    """Object-space stable quadratic with det-scaled t -> (t, valid, t_loc).
    ``rec``: the 14 fields of a general record (inv3, invt, r2, det);
    ``o``/``d``: per-axis component triples."""
    return general_roots(*general_terms(rec, o, d), rec[13])


def general_roots(a, b, cq, discr, det):
    """The general quadratic's (t, valid, t_loc) from its terms and det."""
    sq = safe_sqrt(discr)
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
    inv_perm [S] int32, sboxes [ceil(S_pad/1024), 8]).

    ``perm`` maps a packed row to its sphere, ``inv_perm`` a sphere to its
    packed row. Pad rows are unhittable (r² = -1), their ``perm`` entries
    map to sphere 0, and ``inv_perm`` never points at them. Box slots: lo
    (3), hi (3), the block's min det clamped at 0 (det-scaled hit distances
    can be below the world distance; t_enter times min det bounds them from
    below; 1 for rigid scenes), 0. The boxes are inflated by 1e-4 x (scene
    extent + 1) so f32 rounding in the slab test never culls a true hit. Whole blocks are ordered by their squared
    distance from the camera, nearest first, so primary and near-surface
    rays tighten their bound on the first blocks they visit. ``sboxes`` are
    the superblocks of :func:`v2_superblocks` over the packed order, which
    K5 tests before each run of 8 blocks."""
    rigid = prep.rigid
    s = prep.sphere_center.shape[0]
    dev = prep.sphere_center.device
    perm = morton_order(prep.sphere_center)
    radius = safe_sqrt(prep.sphere_radius2)
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
    boxes = boxes.contiguous()
    return packed.contiguous(), boxes, perm.contiguous(), inv_perm[:s].contiguous(), v2_superblocks(boxes)


# -------------------------------------------------- plain PyTorch versions
def _slab(o, d, boxes, pairs=True, superblock=False):
    """The kernels' slab test, the same float operations (BIG, not inf, so
    that 0 * (1/d) stays 0 on a face; fmin/fmax as the kernels' fminf/fmaxf)
    -> (t_enter, entered): every ray against every block's box ([N, B]), or,
    with ``pairs`` False, ray i against box i of ``boxes`` [N, 8] ([N]).
    ``superblock``: K5's test of a superblock (``csrc/stream_trace.cu``:
    ``super_may_hit``), where an axis whose t0 or t1 is NaN constrains
    nothing, so that it never rejects what a member block's test admits."""
    inv = torch.where(d == 0, BIG, 1.0 / torch.where(d == 0, 1.0, d))
    shape = (o.shape[0], boxes.shape[0]) if pairs else (o.shape[0],)
    t_enter = torch.zeros(shape, dtype=torch.float32, device=o.device)
    t_exit = torch.full_like(t_enter, BIG)
    for ax in range(3):
        col = slice(ax, ax + 1) if pairs else ax
        oa, da, ia = o[:, col], d[:, col], inv[:, col]
        lo, hi = boxes[:, ax], boxes[:, 3 + ax]
        inside = (oa >= lo) & (oa <= hi)
        t0 = (lo - oa) * ia
        t1 = (hi - oa) * ia
        near, far = torch.fmin(t0, t1), torch.fmax(t0, t1)
        if superblock:
            nan = torch.isnan(t0) | torch.isnan(t1)
            near, far = torch.where(nan, -BIG, near), torch.where(nan, BIG, far)
        near = torch.where(da == 0, torch.where(inside, -BIG, BIG), near)
        far = torch.where(da == 0, torch.where(inside, BIG, -BIG), far)
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


def nearest_sphere_plain(rigid: bool, o, d, bound, packed, boxes, sboxes=None):
    """K5's function in plain PyTorch -> (t [N] f32, idx [N] int32).
    ``sboxes`` (K5's superblocks) is taken as :func:`launch_nearest` takes
    it and changes no answer.

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


def occluded_sphere_plain(rigid: bool, o, d, t_cut, excl, packed, boxes, sboxes=None):
    """K6's function in plain PyTorch -> the final bound [N] f32: 0 where a
    valid sphere other than packed row ``excl`` hits strictly below the
    bound in a block the ray's box test (against its live bound) admits,
    else ``t_cut`` (so a ray with ``t_cut == 0`` is 0). The scan and its box
    test are :func:`nearest_sphere_plain`'s. ``sboxes`` (K6's superblocks)
    is taken as :func:`launch_occluded` takes it and changes no answer."""
    t_best = t_cut.clone()

    def visit(rays, blk, t, valid, entered, t_enter_det):
        may = entered & (t_enter_det < t_best[rays])
        rows = torch.arange(blk * BLOCK, (blk + 1) * BLOCK, dtype=torch.int32, device=t.device)
        hit = (valid & (t < t_best[rays][:, None]) & (rows[None, :] != excl[rays][:, None])).any(1)
        t_best[rays] = torch.where(may & hit, 0.0, t_best[rays])

    _block_scan(rigid, o, d, packed, boxes, visit)
    return t_best


# ------------------------------------------- the V1, V2 and V3 designs
#
# kajo_tpu's other nearest-hit designs (K7 V1, K8 V2, K9 V3), chosen with
# NEAREST_DESIGN. Each cuts the rays into tiles of consecutive rays and lets
# a tile's rays decide together which blocks the whole tile scans, with no
# per-ray gate on the scan. For rays near the scene that gives K5's answer
# (the box tests are conservative and a skipped block holds no hit below
# t_best), up to which of two exactly equal t wins. For rays ~1e4 units out,
# where the quadratic reports hits on spheres the ray passes units away
# from (ROADMAP Queue 3), the answer depends on the other rays of the tile:
# the tile size is part of the function, shared by wrapper, kernel and
# plain version, and only the call's rays vote (a partial last tile has no
# padding lanes). kajo_tpu's V1 tile is 4096 rays, its V2/V3 tiles 512.


def _by_tile(x, tile: int, fill):
    """[N, ...] -> [T, tile, ...], T = ceil(N / tile), the last tile padded
    with ``fill``."""
    n = x.shape[0]
    pad = x.new_full((-(-n // tile) * tile - n, *x.shape[1:]), fill)
    return torch.cat([x, pad]).view(-1, tile, *x.shape[1:])


def _tile_bounds(o, d, bound, tile: int):
    """Per tile, over its live rays (d != 0): the origin box, the direction
    box (lo, hi [T, 3] each, ±BIG without live rays), the largest bound (0
    without) and whether it has a live ray -> (olo, ohi, dlo, dhi, tmx,
    has_live)."""
    o_t, d_t, b_t = _by_tile(o, tile, 0.0), _by_tile(d, tile, 0.0), _by_tile(bound, tile, 0.0)
    live = (d_t != 0).any(-1, keepdim=True)
    olo = torch.where(live, o_t, BIG).amin(1)
    ohi = torch.where(live, o_t, -BIG).amax(1)
    dlo = torch.where(live, d_t, BIG).amin(1)
    dhi = torch.where(live, d_t, -BIG).amax(1)
    tmx = torch.where(live[..., 0], b_t, 0.0).amax(1)
    return olo, ohi, dlo, dhi, tmx, live[:, :, 0].any(1)


def interval_div(nl, nh, dl, dh):
    """Interval quotient [nl, nh] / [dl, dh] -> (lo, hi); unbounded
    (±BIG) where the divisor interval holds 0."""
    contains0 = (dl <= 0.0) & (dh >= 0.0)
    sdl = torch.where(contains0, 1.0, dl)
    sdh = torch.where(contains0, 1.0, dh)
    q1, q2, q3, q4 = nl / sdl, nl / sdh, nh / sdl, nh / sdh
    lo = torch.minimum(torch.minimum(q1, q2), torch.minimum(q3, q4))
    hi = torch.maximum(torch.maximum(q1, q2), torch.maximum(q3, q4))
    return torch.where(contains0, -BIG, lo), torch.where(contains0, BIG, hi)


def frustum_reach(olo, ohi, dlo, dhi, tmx, boxes):
    """Per tile and block, the interval slab test of (origin box x
    direction box x [0, tmx)) against the block's box, the lower bound
    scaled by its min det -> bool [T, B]: False where no ray of the tile
    can hit the block below the tile's largest bound. K9 computes it in the
    kernel (csrc/stream_trace_v3.cu, the same operations)."""
    blo, bhi = boxes[None, :, 0:3], boxes[None, :, 3:6]
    olo, ohi, dlo, dhi = (x[:, None, :] for x in (olo, ohi, dlo, dhi))
    # crossing times of each slab plane over every (o, d) of the tile boxes
    q1l, q1h = interval_div(blo - ohi, blo - olo, dlo, dhi)
    q2l, q2h = interval_div(bhi - ohi, bhi - olo, dlo, dhi)
    lb = torch.clamp_min(torch.minimum(q1l, q2l), 0.0).amax(-1)
    ub = torch.maximum(q1h, q2h).amin(-1)
    return (lb <= ub) & (lb * boxes[None, :, 6] < tmx[:, None])


def _visit_lists(reach, key):
    """Per tile, the reachable blocks by ascending ``key`` (a stable sort:
    ties keep block order) -> (lists [T, B] int32, the reachable ones
    first, counts [T] int32)."""
    order = torch.argsort(torch.where(reach, key, float("inf")), dim=1, stable=True)
    return order.to(torch.int32).contiguous(), reach.sum(1).to(torch.int32)


def frustum_candidates(o, d, bound, boxes, tile: int = V1_TILE):
    """K7's frustum order (kajo_tpu ``_frustum_candidates``,
    TILE_FRUSTUM): per tile, the blocks :func:`frustum_reach` admits, in
    ascending block order -> (lists [T, B], counts [T]). A tile without
    live rays visits nothing. (kajo_tpu pads each list with repeats of its
    last candidate, so that Pallas skips their copies, and a tile without
    candidates tests its list's first block once; here a list is block ids
    and a count.)"""
    olo, ohi, dlo, dhi, tmx, has_live = _tile_bounds(o, d, bound, tile)
    reach = frustum_reach(olo, ohi, dlo, dhi, tmx, boxes) & has_live[:, None]
    pos = torch.arange(boxes.shape[0], dtype=torch.float32, device=o.device)
    return _visit_lists(reach, pos.expand(reach.shape))


def _near_far(o, d, lo, hi, tile: int):
    """Per tile and box (lo, hi [B, 3]): the squared distance from the
    tile's mean live origin to the box's centre, and whether the box lies
    behind every live origin along an axis on which every live direction
    has one sign -> (dist [T, B], behind [T, B], has_live [T], tlo, thi
    [T, 3] the live origins' box, live [T, tile, 1])."""
    o_t, d_t = _by_tile(o, tile, 0.0), _by_tile(d, tile, 0.0)
    live = (d_t != 0).any(-1, keepdim=True)
    w = live.to(torch.float32)
    centroid = (o_t * w).sum(1) / torch.clamp_min(w.sum(1), 1.0)
    gap = centroid[:, None, :] - (0.5 * (lo + hi))[None]
    dist = gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1] + gap[..., 2] * gap[..., 2]
    tlo = torch.where(live, o_t, BIG).amin(1)
    thi = torch.where(live, o_t, -BIG).amax(1)
    all_pos = torch.where(live, d_t >= 0, True).all(1)
    all_neg = torch.where(live, d_t <= 0, True).all(1)
    behind = ((all_pos[:, None, :] & (hi[None] < tlo[:, None, :]))
              | (all_neg[:, None, :] & (lo[None] > thi[:, None, :]))).any(-1)
    return dist, behind, live[:, :, 0].any(1), tlo, thi, live


def near_far_order(o, d, boxes, tile: int = V1_TILE):
    """K7's near-to-far order (kajo_tpu NEAR_FAR_ORDER, stream_trace.py
    :395-441): per tile, the blocks not behind its live origins, by the
    distance of their box centre from the tile's mean live origin ->
    (lists [T, B], counts [T])."""
    dist, behind, has_live, *_ = _near_far(o, d, boxes[:, 0:3], boxes[:, 3:6], tile)
    return _visit_lists(~behind & has_live[:, None], dist)


def v2_superblocks(boxes):
    """K8's superblock boxes: the union box and min det of each run of
    V2_SUPER // 128 consecutive blocks -> [ceil(B / 8), 8]. Blocks past the
    scene's last count as (lo +BIG, hi -BIG, min det BIG), as kajo_tpu's
    filler boxes, and widen nothing."""
    per = V2_SUPER // BLOCK
    n_super = -(-boxes.shape[0] // per)
    filler = boxes.new_tensor([BIG] * 3 + [-BIG] * 3 + [BIG, 0.0])
    g = torch.cat([boxes, filler.expand(n_super * per - boxes.shape[0], 8)]).view(n_super, per, 8)
    return torch.cat([g[..., 0:3].amin(1), g[..., 3:6].amax(1), g[..., 6:7].amin(1), torch.zeros_like(g[:, 0, 7:])], 1)


def v2_candidates(o, d, bound, boxes, tile: int = V2_TILE):
    """K8's host side (kajo_tpu ``_nearest_v2_impl`` :594-689): the
    superblock boxes and, per tile, the reachable superblocks near to far:
    not behind the tile's live origins and no farther than its largest
    bound (the box separation, scaled by the min det) -> (sboxes [Bs, 8],
    lists [T, Bs] int32, counts [T] int32). With one superblock every tile
    visits it."""
    sboxes = v2_superblocks(boxes)
    n_super, n_tiles = sboxes.shape[0], -(-o.shape[0] // tile)
    if n_super == 1:
        lists = torch.zeros((n_tiles, 1), dtype=torch.int32, device=o.device)
        return sboxes, lists, torch.ones(n_tiles, dtype=torch.int32, device=o.device)
    sb_lo, sb_hi = sboxes[:, 0:3], sboxes[:, 3:6]
    dist, behind, has_live, tlo, thi, live = _near_far(o, d, sb_lo, sb_hi, tile)
    tm_max = torch.where(live[..., 0], _by_tile(bound, tile, 0.0), 0.0).amax(1)
    # per-axis box separation bounds the hit distance of a unit direction
    sep = torch.maximum(sb_lo[None] - thi[:, None, :], tlo[:, None, :] - sb_hi[None])
    lb = torch.clamp_min(sep, 0.0).amax(-1)
    reach = ~behind & (lb * sboxes[None, :, 6] < tm_max[:, None]) & has_live[:, None]
    return (sboxes, *_visit_lists(reach, dist))


def _vote(o, d, t_best, gate, tile: int, active=None):
    """Each tile's verdict [T]: whether any of its rays (those ``active``,
    if given) enters its gate box (``gate`` [N, 8], the box of each ray's
    tile) below its live bound."""
    t_enter, entered = _slab(o, d, gate, pairs=False)
    may = entered & (t_enter * gate[:, 6] < t_best)
    if active is not None:
        may &= active
    verdict = _by_tile(may, tile, False).any(1)
    if _scan_counts is not None:
        _scan_counts["tiles"] = _scan_counts["tiles"].to(verdict.device) + verdict
    return verdict


@contextlib.contextmanager
def counting_scans():
    """Count what the designs' plain versions scan inside the block -> a
    dict: "pairs", the (ray, 128-sphere block) pairs tested; "roots", the
    (ray, sphere) pairs among them whose discriminant is >= 0, the only ones
    whose roots the answer needs (a 0-d tensor); "blocks", the set of
    blocks some ray tested (what K7-K9's functions must do, for their
    bounds); and "tiles", per tile the blocks (K7) or superblocks (K8) its
    vote admitted ([T] int64; a 0-d zero until a vote is taken)."""
    global _scan_counts
    zero = torch.zeros((), dtype=torch.int64)
    before, _scan_counts = _scan_counts, {"pairs": 0, "roots": zero, "blocks": set(), "tiles": zero}
    try:
        yield _scan_counts
    finally:
        _scan_counts = before


def _scan(rigid, o, d, rays, blk, packed, t_best, idx):
    """Rays ``rays`` (indices) scan the 128-sphere block ``blk`` (an int, or
    a block per ray of ``rays``) in order with a strict t < t_best (the
    first packed row wins a tie); updates t_best and idx in place."""
    if _scan_counts is not None and rays.shape[0]:
        _scan_counts["pairs"] += int(rays.shape[0])
        _scan_counts["blocks"].update([blk] if isinstance(blk, int) else torch.unique(blk).tolist())
    fields = packed.shape[1]
    blocks = packed.view(-1, BLOCK, fields)
    step = max(1, _PLAIN_CHUNK_ELEMS // (BLOCK * fields))
    for r0 in range(0, rays.shape[0], step):
        r = rays[r0 : r0 + step]
        ocol, dcol, d_dot_o, o2 = ray_terms(o[r], d[r])
        if isinstance(blk, int):
            rec, base = blocks[blk].T, blk * BLOCK  # [F, 128]
        else:
            b = blk[r0 : r0 + step]
            rec, base = blocks[b].permute(2, 0, 1), b * BLOCK  # [F, m, 128]
        if rigid:
            terms = rigid_terms(rec[0], rec[1], rec[2], rigid_const(*rec), ocol, dcol, d_dot_o, o2)
            t, valid = rigid_roots(*terms)
        else:
            terms = general_terms(rec, ocol, dcol)
            t, valid, _ = general_roots(*terms, rec[13])
        if _scan_counts is not None:
            _scan_counts["roots"] = _scan_counts["roots"].to(t.device) + (terms[-1] >= 0).sum()
        t_min, arg = torch.min(torch.where(valid, t, float("inf")), 1)
        tb = t_best[r]
        better = t_min < tb
        t_best[r] = torch.where(better, t_min, tb)
        idx[r] = torch.where(better, (arg + base).to(torch.int32), idx[r])


def _rays_of(tiles, tile: int, n: int):
    """Indices of the rays of the tiles set in ``tiles`` [T]."""
    return torch.nonzero(tiles.repeat_interleave(tile)[:n]).squeeze(1)


def nearest_v1_plain(rigid: bool, o, d, bound, packed, boxes, order=None, tile: int = V1_TILE):
    """K7's function in plain PyTorch -> (t [N] f32, idx [N] int32 packed
    row, -1 where nothing beat the bound).

    Tiles of ``tile`` consecutive rays walk their blocks: every block in
    packed order (``order`` None), or the first ``counts[j]`` of row j of
    ``order`` = (lists, counts). Per block, if any ray of the tile enters
    the block's box below its live bound, every ray of the tile scans the
    block with a strict t < t_best (kajo_tpu V1, stream_trace.py:141; there
    the tile is 4096 rays, here V1_TILE, the kernel's)."""
    n = o.shape[0]
    t_best = bound.clone()
    idx = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    if n == 0:
        return t_best, idx
    if order is None:
        for blk in range(boxes.shape[0]):
            vote = _vote(o, d, t_best, boxes[blk].expand(n, 8), tile)
            _scan(rigid, o, d, _rays_of(vote, tile, n), blk, packed, t_best, idx)
        return t_best, idx
    lists, counts = order
    ray_tile = torch.arange(n, device=o.device) // tile
    for s in range(int(counts.max())):
        b_ray = torch.where(s < counts, lists[:, s], -1).long()[ray_tile]
        act = b_ray >= 0
        vote = _vote(o, d, t_best, boxes[b_ray.clamp_min(0)], tile, act)
        rays = _rays_of(vote, tile, n)
        _scan(rigid, o, d, rays, b_ray[rays], packed, t_best, idx)
    return t_best, idx


def nearest_v2_plain(rigid: bool, o, d, bound, packed, boxes, cand=None, tile: int = V2_TILE):
    """K8's function in plain PyTorch -> (t [N] f32, idx [N] int32).

    ``cand`` = (sboxes, lists, counts) of :func:`v2_candidates` (built here
    when None). Tiles of ``tile`` rays walk their candidate superblocks in
    list order; per candidate, if any ray of the tile enters the
    superblock's box below its live bound, every ray of the tile scans its
    blocks in order with a strict t < t_best: kajo_tpu V2's per-128-chunk
    minimum with the lowest lane on ties (stream_trace.py:516)."""
    n = o.shape[0]
    sboxes, lists, counts = v2_candidates(o, d, bound, boxes, tile) if cand is None else cand
    t_best = bound.clone()
    idx = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    if n == 0:
        return t_best, idx
    n_blocks, per = boxes.shape[0], V2_SUPER // BLOCK
    ray_tile = torch.arange(n, device=o.device) // tile
    for s in range(int(counts.max())):
        sb_ray = torch.where(s < counts, lists[:, s], -1).long()[ray_tile]
        act = sb_ray >= 0
        vote = _vote(o, d, t_best, sboxes[sb_ray.clamp_min(0)], tile, act)
        rays = _rays_of(vote, tile, n)
        for c in range(per):
            blk = sb_ray[rays] * per + c
            inside = blk < n_blocks  # past the scene's last block: nothing to scan
            _scan(rigid, o, d, rays[inside], blk[inside], packed, t_best, idx)
    return t_best, idx


def nearest_v3_plain(rigid: bool, o, d, bound, packed, boxes, tile: int = V3_TILE):
    """K9's function in plain PyTorch -> (t [N] f32, idx [N] int32).

    Per tile of ``tile`` rays, :func:`frustum_reach` of its live rays'
    bounds marks blocks; every ray of the tile scans the marked blocks in
    ascending order with a strict t < t_best, no per-ray gate (kajo_tpu V3,
    stream_trace.py:757)."""
    n = o.shape[0]
    t_best = bound.clone()
    idx = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    if n == 0:
        return t_best, idx
    olo, ohi, dlo, dhi, tmx, _ = _tile_bounds(o, d, bound, tile)
    marks = frustum_reach(olo, ohi, dlo, dhi, tmx, boxes)
    for blk in torch.nonzero(marks.any(0)).squeeze(1).tolist():
        _scan(rigid, o, d, _rays_of(marks[:, blk], tile, n), blk, packed, t_best, idx)
    return t_best, idx


# ------------------------------------------------------------------ CUDA
def _check(name, x, dtype, shape):
    if x.device.type != "cuda" or x.dtype != dtype or not x.is_contiguous() or tuple(x.shape) != shape:
        raise ValueError(
            f"{name}: the CUDA stream trace takes a contiguous {dtype} {shape} tensor on a CUDA device, "
            f"got {x.dtype} {tuple(x.shape)} on {x.device}"
        )


def _run(source: str, name: str, o, *args) -> None:
    """Call C function ``name`` of ``csrc/<source>`` on the current stream
    of ``o``'s device: tensors go as pointers, None as NULL, ints as ints;
    raises if the launch reports a CUDA error."""
    from ._nvcc import load_library

    fn = getattr(load_library(source), name)
    fn.argtypes = [ctypes.c_int if isinstance(a, int) else ctypes.c_void_p for a in args] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _check_trace(rigid: bool, o, d, bound, packed, boxes):
    """Check a stream trace's inputs -> (n rays, n blocks)."""
    n = o.shape[0]
    n_blocks = packed.shape[0] // BLOCK
    _check("o", o, torch.float32, (n, 3))
    _check("d", d, torch.float32, (n, 3))
    _check("bound", bound, torch.float32, (n,))
    _check("packed", packed, torch.float32, (n_blocks * BLOCK, F_RIGID if rigid else F_GENERAL))
    _check("boxes", boxes, torch.float32, (n_blocks, 8))
    return n, n_blocks


def launch_nearest(rigid: bool, o, d, bound, packed, boxes, sboxes=None):
    """Launch K5 on the current stream -> (t [N], packed idx [N] int32),
    the function of :func:`nearest_sphere_plain`. ``sboxes``: the scene's
    superblocks (``PreparedScene.stream_sboxes``), built here from
    ``boxes`` when None."""
    global nearest_launches
    n, n_blocks = _check_trace(rigid, o, d, bound, packed, boxes)
    sboxes = v2_superblocks(boxes) if sboxes is None else sboxes
    _check("sboxes", sboxes, torch.float32, (-(-n_blocks // (V2_SUPER // BLOCK)), 8))
    t_out, idx_out = _outputs(o)
    _run("stream_trace.cu", "kajo_stream_nearest", o, o, d, bound, packed, boxes, sboxes, t_out, idx_out, n, n_blocks,
         int(rigid))
    nearest_launches += 1
    return t_out, idx_out


def launch_occluded(rigid: bool, o, d, t_cut, excl, packed, boxes, sboxes=None):
    """Launch K6 on the current stream -> final bound [N], the function of
    :func:`occluded_sphere_plain`. ``sboxes``: the scene's superblocks
    (``PreparedScene.stream_sboxes``), built here from ``boxes`` when None."""
    global occluded_launches
    n, n_blocks = _check_trace(rigid, o, d, t_cut, packed, boxes)
    _check("excl", excl, torch.int32, (n,))
    sboxes = v2_superblocks(boxes) if sboxes is None else sboxes
    _check("sboxes", sboxes, torch.float32, (-(-n_blocks // (V2_SUPER // BLOCK)), 8))
    t_out = torch.empty((n,), dtype=torch.float32, device=o.device)
    _run("stream_trace.cu", "kajo_stream_occluded", o, o, d, t_cut, packed, boxes, sboxes, t_out, excl, n, n_blocks,
         int(rigid))
    occluded_launches += 1
    return t_out


def _outputs(o):
    n = o.shape[0]
    return (torch.empty((n,), dtype=torch.float32, device=o.device),
            torch.empty((n,), dtype=torch.int32, device=o.device))


def _check_lists(lists, counts, n_tiles: int, width: int):
    _check("lists", lists, torch.int32, (n_tiles, width))
    _check("counts", counts, torch.int32, (n_tiles,))


def launch_nearest_v1(rigid: bool, o, d, bound, packed, boxes, order=None):
    """Launch K7 on the current stream -> (t [N], packed idx [N] int32),
    the function of :func:`nearest_v1_plain` (``order``: None for packed
    order, else (lists, counts) at V1_TILE)."""
    global nearest_v1_launches
    n, n_blocks = _check_trace(rigid, o, d, bound, packed, boxes)
    lists = counts = None
    if order is not None:
        lists, counts = order
        _check_lists(lists, counts, -(-n // V1_TILE), n_blocks)
    t_out, idx_out = _outputs(o)
    _run("stream_trace_v1.cu", "kajo_stream_nearest_v1", o, o, d, bound, packed, boxes, lists, counts, t_out,
         idx_out, n, n_blocks, int(rigid))
    nearest_v1_launches += 1
    return t_out, idx_out


def launch_nearest_v2(rigid: bool, o, d, bound, packed, boxes, cand=None):
    """Launch K8 on the current stream -> (t [N], packed idx [N] int32),
    the function of :func:`nearest_v2_plain` (``cand``: the (sboxes, lists,
    counts) of :func:`v2_candidates` at V2_TILE, built here when None)."""
    global nearest_v2_launches
    n, n_blocks = _check_trace(rigid, o, d, bound, packed, boxes)
    sboxes, lists, counts = v2_candidates(o, d, bound, boxes) if cand is None else cand
    n_super = -(-n_blocks // (V2_SUPER // BLOCK))
    _check("sboxes", sboxes, torch.float32, (n_super, 8))
    _check_lists(lists, counts, -(-n // V2_TILE), n_super)
    t_out, idx_out = _outputs(o)
    _run("stream_trace_v2.cu", "kajo_stream_nearest_v2", o, o, d, bound, packed, sboxes, lists, counts, t_out,
         idx_out, n, n_blocks, n_super, int(rigid))
    nearest_v2_launches += 1
    return t_out, idx_out


def launch_nearest_v3(rigid: bool, o, d, bound, packed, boxes):
    """Launch K9 on the current stream -> (t [N], packed idx [N] int32),
    the function of :func:`nearest_v3_plain`: its marks, a CTA per tile
    and range of marked blocks, and each ray's answer taken from a 64-bit
    key that the ranges lower (three launches, one counted). Scratch,
    allocated here: 4 bytes a tile and block (the tiles' lists of marked
    blocks, 300 KB for 49,152 rays on 782 blocks) and 8 bytes a ray."""
    global nearest_v3_launches
    n, n_blocks = _check_trace(rigid, o, d, bound, packed, boxes)
    n_tiles = -(-n // V3_TILE)
    lists = torch.empty((n_tiles, n_blocks), dtype=torch.int32, device=o.device)
    counts = torch.empty((n_tiles,), dtype=torch.int32, device=o.device)
    keys = torch.empty((n,), dtype=torch.int64, device=o.device)
    t_out, idx_out = _outputs(o)
    _run("stream_trace_v3.cu", "kajo_stream_nearest_v3", o, o, d, bound, packed, boxes, lists, counts, keys, t_out,
         idx_out, n, n_blocks, int(rigid))
    nearest_v3_launches += 1
    return t_out, idx_out


# ------------------------------------------------------------- host side
def _device_kind(x):
    kind = x.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no stream trace for device {x.device}")
    return kind


def _checked_design(name: str) -> str:
    if name not in DESIGNS:
        raise ValueError(f"unknown nearest-hit design {name!r}; the designs are {', '.join(DESIGNS)}")
    return name


@contextlib.contextmanager
def nearest_design(name: str):
    """Route every :func:`nearest_sphere` call inside the block through the
    design ``name`` (one of DESIGNS), then restore the setting."""
    global NEAREST_DESIGN
    before, NEAREST_DESIGN = NEAREST_DESIGN, _checked_design(name)
    try:
        yield
    finally:
        NEAREST_DESIGN = before


def design_lists(design: str, o, d, bound, boxes) -> tuple:
    """A design's host side: the arguments its kernel and plain version
    take after ``boxes`` -> (order,) for K7 (None: packed order, also on a
    one-block scene, as kajo_tpu), (cand,) for K8, () for K5 and K9."""
    if design.startswith("v1"):
        if boxes.shape[0] > 1 and design == "v1-frustum":
            return (frustum_candidates(o, d, bound, boxes),)
        if boxes.shape[0] > 1 and design == "v1-near-far":
            return (near_far_order(o, d, boxes),)
        return (None,)
    if design == "v2":
        return (v2_candidates(o, d, bound, boxes),)
    return ()


def t_recompute(rigid: bool, rec, o, d):
    """The hit distance of each ray [N, 3] on its own record [N, 4 | 14]
    (kajo_tpu's ``_t_recompute``): the quadratic of the kernels, as a
    differentiable function of the record and the ray."""
    ot, dt = tuple(o.T), tuple(d.T)
    if rigid:
        d_dot_o = dt[0] * ot[0] + dt[1] * ot[1] + dt[2] * ot[2]
        o2 = ot[0] * ot[0] + ot[1] * ot[1] + ot[2] * ot[2]
        return quadratic_rigid(*rec.T, ot, dt, d_dot_o, o2)[0]
    return quadratic_general(tuple(rec.T), ot, dt)[0]


def nearest_vjp(rigid: bool, o, d, packed, idx, gt):
    """The backward of the nearest hit's t (kajo_tpu's ``_nearest_bwd``):
    the winner's t recomputed from its packed record, its cotangent ``gt``
    (0 on a miss) pulled back -> (grad o, grad d, grad packed). A record's
    gradient is the sum over the rays it won, by ``index_put_`` with
    ``accumulate``, which on the card sorts the rows and adds each row's
    terms in a fixed order (no float atomics), so a backward repeats bit
    for bit."""
    hit = idx >= 0
    safe = idx.clamp_min(0).long()
    with torch.enable_grad():
        rec = packed[safe].detach().requires_grad_(True)
        o_, d_ = o.detach().requires_grad_(True), d.detach().requires_grad_(True)
        t = t_recompute(rigid, rec, o_, d_)
        grec, go, gd = torch.autograd.grad(t, (rec, o_, d_), torch.where(hit, gt, 0.0))
    gpacked = torch.zeros_like(packed).index_put_((safe,), torch.where(hit[:, None], grec, 0.0), accumulate=True)
    return go, gd, gpacked


class _NearestHit(torch.autograd.Function):
    """The nearest hit (kajo_tpu's ``_nearest`` custom_vjp): the forward is
    the design's answer, computed without a graph; the backward is
    :func:`nearest_vjp`, to the rays and the packed records. The bound and
    the boxes only gate the search: no gradient."""

    @staticmethod
    def forward(ctx, rigid, find, o, d, bound, packed, boxes):
        t, idx = find(rigid, o, d, bound, packed, boxes)
        ctx.rigid = rigid
        ctx.save_for_backward(o, d, packed, idx)
        ctx.mark_non_differentiable(idx)
        return t, idx

    @staticmethod
    def backward(ctx, gt, _gidx):
        o, d, packed, idx = ctx.saved_tensors
        go, gd, gpacked = nearest_vjp(ctx.rigid, o, d, packed, idx, gt)
        return None, None, go, gd, None, gpacked, None


def nearest_sphere(prep, o, d, t_max=None, design=None):
    """Streamed nearest-sphere hit for a prepared scene with a stream
    packing -> (t [N] with inf on miss, sphere index [N] in scene numbering,
    -1 on miss). ``t_max`` (per ray, optional) bounds the search. ``design``
    (one of DESIGNS) overrides NEAREST_DESIGN; CPU rays take the design's
    plain version, CUDA rays its kernel, with its block lists built on the
    rays' device. t is differentiable in ``o``, ``d`` and the packed
    records (so in the spheres' transforms and radii), through
    :class:`_NearestHit`."""
    design = _checked_design(NEAREST_DESIGN if design is None else design)
    n = o.shape[0]
    bound = o.new_full((n,), BIG) if t_max is None else torch.clamp_max(t_max.to(torch.float32), BIG)
    o, d, bound = o.contiguous(), d.contiguous(), bound.contiguous()
    packed, boxes = prep.stream_packed, prep.stream_boxes
    cpu = _device_kind(o) == "cpu"
    if design == "v3" and packed.numel() * 4 > V3_RESIDENT_BYTES:
        design = "v1"  # too big to keep resident: V1 in packed order, as kajo_tpu
    plain, launch = {
        "v4": (nearest_sphere_plain, launch_nearest), "v1": (nearest_v1_plain, launch_nearest_v1),
        "v2": (nearest_v2_plain, launch_nearest_v2), "v3": (nearest_v3_plain, launch_nearest_v3),
    }[design[:2]]
    # K5 takes the scene's superblocks; the plain K5 needs none
    with torch.no_grad():
        lists = (prep.stream_sboxes,) if design == "v4" and not cpu else design_lists(design, o, d, bound, boxes)
    find = plain if cpu else launch
    t, idx = _NearestHit.apply(prep.rigid, lambda *a: find(*a, *lists), o, d, bound, packed, boxes)
    found = idx >= 0
    idx_orig = torch.where(found, prep.stream_perm[idx.clamp_min(0).long()], -1)
    return torch.where(found, t, float("inf")), idx_orig


def occluded_sphere(prep, o, d, t_cut, excl=None):
    """Any-hit occlusion -> bool [N]: True where some sphere's hit t is
    strictly below ``t_cut``, skipping the packed row ``excl`` (int32 per
    ray, -1 = none). A ray with ``t_cut <= 0`` reports occluded at no cost.
    Every design keeps this K6 path, as kajo_tpu's occluded_sphere does."""
    n = o.shape[0]
    tc = torch.clamp(t_cut.to(torch.float32), 0.0, BIG).contiguous()
    if excl is None:
        excl = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    excl = excl.to(torch.int32).contiguous()
    o, d = o.contiguous(), d.contiguous()
    if _device_kind(o) == "cpu":
        out = occluded_sphere_plain(prep.rigid, o, d, tc, excl, prep.stream_packed, prep.stream_boxes)
    else:
        out = launch_occluded(prep.rigid, o, d, tc, excl, prep.stream_packed, prep.stream_boxes, prep.stream_sboxes)
    return out == 0.0
