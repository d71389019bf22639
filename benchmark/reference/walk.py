"""The path-tracing lane loop of K1, vectorised over lanes with masks, and the
image of a batch of passes.

:func:`trace_lanes` runs the passes of a batch at once: lane ``j`` of pass
``i`` is row ``i * W * H + j``, with the pass's own seed, and every update
is masked by ``active`` so that lanes that finished their samples keep
their sums while the others run on. One lane walks its eff = floor(sqrt(spp))²
stratified samples one after another (regeneration): camera ray, nearest hit
over planes then spheres (rigid 4-float or general 23-float records),
Russian roulette, the BSDF lottery (transmit, Lambert, Phong, mirror), NEE
over every light or one drawn uniformly, the deferred MIS weight, emission
and background. The uniforms are PCG4D of (lane, sample, salt, pass seed).

``dtype`` is the arithmetic's type: float32 is the reference; a lower one
is the benchmark's control (``bfloat16``). With ``stats``, the walk counts
per batch the path rays, shadow rays, hits and continuations by each BSDF,
from which the benchmark counts K1's operations.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .rng import pass_seed, uniforms4
from .scene import GENERAL_FLOATS, LIGHT_FLOATS, MATERIAL_FLOATS, PLANE_FLOATS, RIGID_FLOATS, PackedScene

FLT_EPSILON = 1.1920928955078125e-07
BIG = 3.0e38
PI = float(np.float32(np.pi))
CAM_SALT = 0x7FFFFFFF
STATS = ("rays", "shadow_rays", "hits", "lambert", "phong", "mirror", "transmit")


@dataclasses.dataclass(frozen=True)
class Estimator:
    """The estimator's settings, as a configuration file states them."""

    max_depth: int = 8
    surface_epsilon: float = 1e-3
    direct_lighting: bool = True
    full_mis: bool = False
    kajo_spp_quirk: bool = True
    regen_threshold: float = 0.0
    one_light_nee: bool = False


def _add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def _mul(a, b):
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def _where(m, a, b):
    return tuple(torch.where(m, x, y) for x, y in zip(a, b))


def _normalize(a):
    """Unit vector; 0 for a zero vector."""
    n2 = _dot(a, a)
    nz = n2 > 0
    inv = torch.rsqrt(torch.where(nz, n2, 1.0))
    return tuple(torch.where(nz, x * inv, 0.0) for x in a)


def _reflect(v, n):
    return _sub(v, _scale(n, 2.0 * _dot(n, v)))


def _sqrt(x):
    return torch.sqrt(torch.clamp_min(x, 0.0))


def _pow(x, n):
    """x**n as exp(n log x); 0 for x <= 0, except 1 where n == 0."""
    m = x > 0
    return torch.where(m, torch.exp(n * torch.log(torch.where(m, x, 1.0))), torch.where(n == 0, 1.0, 0.0))


def _sphere_hit_general(rec, o, d):
    """Object-space quadratic of a general sphere record; t scaled by the
    determinant; the normal is the object-space hit point under the forward
    matrix, normalised -> (t, valid, normal)."""
    ox = rec[0] * o[0] + rec[1] * o[1] + rec[2] * o[2] + rec[9]
    oy = rec[3] * o[0] + rec[4] * o[1] + rec[5] * o[2] + rec[10]
    oz = rec[6] * o[0] + rec[7] * o[1] + rec[8] * o[2] + rec[11]
    dx = rec[0] * d[0] + rec[1] * d[1] + rec[2] * d[2]
    dy = rec[3] * d[0] + rec[4] * d[1] + rec[5] * d[2]
    dz = rec[6] * d[0] + rec[7] * d[1] + rec[8] * d[2]
    r2, det = rec[12], rec[13]
    a = dx * dx + dy * dy + dz * dz
    b = 2.0 * (dx * ox + dy * oy + dz * oz)
    cq = ox * ox + oy * oy + oz * oz - r2
    discr = b * b - 4.0 * a * cq
    sq = _sqrt(discr)
    q = torch.where(b < 0, (-b - sq) * 0.5, (-b + sq) * 0.5)
    t0 = q / torch.where(a == 0, 1.0, a)
    t1 = cq / torch.where(q == 0, 1.0, q)
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    t_loc = torch.where(lo < 0, hi, lo)
    t = t_loc * det
    valid = (discr >= 0) & (hi >= 0) & (a != 0) & (q != 0) & (t >= 0)
    nl = (ox + dx * t_loc, oy + dy * t_loc, oz + dz * t_loc)
    n = _normalize(
        (
            rec[14] * nl[0] + rec[15] * nl[1] + rec[16] * nl[2],
            rec[17] * nl[0] + rec[18] * nl[1] + rec[19] * nl[2],
            rec[20] * nl[0] + rec[21] * nl[1] + rec[22] * nl[2],
        )
    )
    return t, valid, n


def trace_lanes(
    scene: PackedScene,
    seeds,
    width: int,
    height: int,
    spp: int,
    est: Estimator,
    dtype=torch.float32,
    stats: dict | None = None,
) -> torch.Tensor:
    """The RGB sums of every lane of the passes with u32 seeds ``seeds`` ->
    [len(seeds), 3, W * H] float32."""
    s = scene.packed.to(dtype)
    dev = s.device
    P, S, L = scene.n_planes, scene.n_spheres, scene.n_lights
    rigid = scene.rigid
    spf = RIGID_FLOATS if rigid else GENERAL_FLOATS
    off_spheres = P * PLANE_FLOATS
    off_mats = off_spheres + S * spf
    off_lights = off_mats + (P + S) * MATERIAL_FLOATS
    off_bg = off_lights + L * LIGHT_FLOATS
    off_cam = off_bg + 3
    grid_n = max(int(spp**0.5), 1)
    eff = grid_n * grid_n
    nee_on = bool(est.direct_lighting and L > 0)
    one_light = bool(est.one_light_nee and L > 1)
    emit_after_scatter = bool((not est.direct_lighting) or est.full_mis)
    # PCG4D calls a bounce: roulette, transmit, diffuse-or-specular, two for
    # the continuation, then three a light (or one to choose and three)
    ncalls = -(-max(5 + 3 * L, 9 if one_light else 0) // 4)

    def const(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    pi, two_pi = const(PI), const(2.0 * PI)
    fgrid, fw, fh = const(grid_n), const(width), const(height)
    eps = const(est.surface_epsilon)
    planes = [[s[i * PLANE_FLOATS + j] for j in range(PLANE_FLOATS)] for i in range(P)]
    spheres = [[s[off_spheres + i * spf + j] for j in range(spf)] for i in range(S)]
    sphere_c2 = [c[0] * c[0] + c[1] * c[1] + c[2] * c[2] - c[3] for c in spheres] if rigid else []
    mat_table = s[off_mats:off_lights].reshape(P + S, MATERIAL_FLOATS)
    light_table = s[off_lights:off_bg].reshape(L, LIGHT_FLOATS)
    lights = [[light_table[i, j] for j in range(LIGHT_FLOATS)] for i in range(L)]
    light_ids = light_table[:, 7].to(torch.int64)
    bg = tuple(s[off_bg + j] for j in range(3))
    origin0 = tuple(s[off_cam + j] for j in range(3))
    p1 = tuple(s[off_cam + 3 + j] for j in range(3))
    du = tuple(s[off_cam + 6 + j] for j in range(3))
    dv = tuple(s[off_cam + 9 + j] for j in range(3))

    n_pix = width * height
    row = torch.arange(len(seeds) * n_pix, dtype=torch.int64, device=dev)
    lane = row % n_pix
    seed_t = torch.tensor([int(x) & 0xFFFFFFFF for x in seeds], dtype=torch.int64, device=dev)[row // n_pix]
    px = (lane % width).to(dtype)
    py = (lane // width).to(dtype)
    zf = torch.zeros(lane.shape, dtype=dtype, device=dev)
    zi = torch.zeros(lane.shape, dtype=torch.int64, device=dev)
    counts = {k: torch.zeros((), dtype=torch.int64, device=dev) for k in STATS} if stats is not None else None

    def camera_ray(sample):
        gx = (sample % grid_n).to(dtype)
        gy = (sample // grid_n).to(dtype)
        u1, u2, _, _ = uniforms4(lane, sample, CAM_SALT, seed_t, dtype)
        sx = (px + (gx + u1) / fgrid) / fw
        sy = ((fh - py) + (gy + u2) / fgrid) / fh
        d = _normalize(_sub(_add(p1, _add(_scale(du, sx), _scale(dv, sy))), origin0))
        return tuple(zf + c for c in origin0), d

    def trace(o, d):
        """Nearest hit over planes then spheres -> (t, object, normal)."""
        t_best = zf + BIG
        obj_best = zi - 1
        n_best = (zf, zf, zf)
        for i, r in enumerate(planes):
            denom = d[0] * r[0] + d[1] * r[1] + d[2] * r[2]
            onum = o[0] * r[0] + o[1] * r[1] + o[2] * r[2] + r[3]
            t_loc = -onum / torch.where(denom == 0, 1.0, denom)
            t = t_loc * r[4]
            valid = (denom.abs() >= FLT_EPSILON) & (t_loc >= 0) & (t >= 0) & (t < t_best)
            t_best = torch.where(valid, t, t_best)
            obj_best = torch.where(valid, i, obj_best)
            n_best = _where(valid, (r[5], r[6], r[7]), n_best)
        if not rigid:
            for i in range(S):
                t, valid, n_new = _sphere_hit_general(spheres[i], o, d)
                valid = valid & (t < t_best)
                t_best = torch.where(valid, t, t_best)
                obj_best = torch.where(valid, P + i, obj_best)
                n_best = _where(valid, n_new, n_best)
            return t_best, obj_best, n_best
        d_dot_o = _dot(d, o)
        o2 = _dot(o, o)
        for i in range(S):
            cx, cy, cz, _ = spheres[i]
            d_dot_c = d[0] * cx + d[1] * cy + d[2] * cz
            o_dot_c = o[0] * cx + o[1] * cy + o[2] * cz
            b = 2.0 * (d_dot_o - d_dot_c)
            cq = o2 - 2.0 * o_dot_c + sphere_c2[i]
            discr = b * b - 4.0 * cq
            sq = _sqrt(discr)
            q = torch.where(b < 0, (-b - sq) * 0.5, (-b + sq) * 0.5)
            t1 = cq / torch.where(q == 0, 1.0, q)
            lo = torch.minimum(q, t1)
            hi = torch.maximum(q, t1)
            t = torch.where(lo < 0, hi, lo)
            valid = (discr >= 0) & (hi >= 0) & (q != 0) & (t >= 0) & (t < t_best)
            t_best = torch.where(valid, t, t_best)
            obj_best = torch.where(valid, P + i, obj_best)
            n_best = _where(valid, _normalize(_sub(_add(o, _scale(d, t)), (cx, cy, cz))), n_best)
        return t_best, obj_best, n_best

    def tangent_frame(n):
        smallest = torch.minimum(n[2], torch.minimum(n[0], n[1]))
        mx = n[0] == smallest
        my = n[1] == smallest
        t = _where(mx, (zf, -n[2], n[1]), _where(my, (-n[2], zf, n[0]), (-n[1], n[0], zf)))
        flat = n[1].abs() < 0.9
        up = (torch.where(flat, 0.0, 1.0).to(dtype), torch.where(flat, 1.0, 0.0).to(dtype), zf)
        t = _where(_dot(t, t) < 1e-12, _cross(n, up), t)
        t = _normalize(t)
        return t, _cross(n, t)

    def solid_angle(dist, rad):
        x = torch.clamp(rad / torch.clamp_min(dist, 1e-30), 0.0, 1.0)
        omega = two_pi * (x * x) / (1.0 + _sqrt(1.0 - x * x))
        return torch.where(dist < rad, 4.0 * PI, omega)

    def light_pdf_from(pos, prev_obj, hit_obj):
        pdf = zf
        for r, obj_id in zip(lights, light_ids):
            delta = _sub((r[0], r[1], r[2]), pos)
            dist = _sqrt(_dot(delta, delta))
            ok = (hit_obj == obj_id) & (prev_obj != obj_id)
            pdf = pdf + torch.where(ok, 1.0 / solid_angle(dist, r[3]), 0.0)
        return pdf

    def add_term(r3, mask, term):
        return _where(mask, _add(r3, term), r3)

    sample = zi.clone()
    depth = zi.clone()
    o, d = camera_ray(sample)
    t3 = (zf + 1.0, zf + 1.0, zf + 1.0)
    r3 = (zf, zf, zf)
    emit = torch.ones_like(zi, dtype=torch.bool)
    misp = torch.zeros_like(emit)
    ppdf = zf + 1.0
    pfcos = (zf + 1.0, zf + 1.0, zf + 1.0)
    pdelta = torch.zeros_like(emit)
    prev_obj = zi - 1
    prev_pos = (zf, zf, zf)

    while True:
        active = sample < eff
        if not bool(active.any()):
            break
        salt0 = depth * ncalls
        us = []
        for i in range(ncalls):
            us.extend(uniforms4(lane, sample, (salt0 + i) & 0xFFFFFFFF, seed_t, dtype))

        t_hit, obj, normal = trace(o, d)
        was_hit = obj >= 0
        pos_hit = _add(o, _scale(d, torch.where(was_hit, t_hit, 0.0)))

        # the deferred MIS weight of the previous vertex
        pdf_l_vis = light_pdf_from(prev_pos, prev_obj, obj) if L else zf
        if est.full_mis:
            pdf_l_vis = torch.where(pdelta, 0.0, pdf_l_vis)
        denom = pdf_l_vis + ppdf
        w = 1.0 / torch.where(denom == 0, 1.0, denom)
        t3 = _where(misp & active, _mul(t3, _scale(pfcos, w)), t3)

        # a miss adds the background and ends the path
        r3 = add_term(r3, active & ~was_hit, _mul(t3, bg))
        on_path = active & was_hit

        mat = mat_table[obj.clamp_min(0)]
        md = (mat[:, 0], mat[:, 1], mat[:, 2])
        ms = (mat[:, 3], mat[:, 4], mat[:, 5])
        me = (mat[:, 6], mat[:, 7], mat[:, 8])
        mt = (mat[:, 9], mat[:, 10], mat[:, 11])
        mexp = mat[:, 12]
        mior = mat[:, 13]

        # Russian roulette and the depth limit
        p_rr = torch.maximum(
            torch.maximum(torch.maximum(md[0], ms[0]), torch.maximum(md[1], ms[1])),
            torch.maximum(torch.maximum(md[2], ms[2]), torch.maximum(torch.maximum(mt[0], mt[1]), mt[2])),
        )
        cont = (p_rr > 0) & (us[0] <= p_rr)
        prob_rr = torch.where(cont, p_rr, 1.0 - p_rr)
        t3 = _where(on_path, _scale(t3, 1.0 / prob_rr), t3)
        tk = t3
        emitter = on_path & emit
        survive = on_path & cont & (depth < est.max_depth)

        # the BSDF lottery
        sum_d = md[0] + md[1] + md[2]
        sum_s = ms[0] + ms[1] + ms[2]
        sum_t = mt[0] + mt[1] + mt[2]
        total = sum_d + sum_s + sum_t
        p_t = torch.where(total > 0, sum_t / torch.where(total == 0, 1.0, total), 0.0)
        transmit = (p_t > 0) & (us[1] <= p_t)
        prob_t = torch.where(transmit, p_t, 1.0 - p_t)
        t3 = _where(survive, _scale(t3, 1.0 / prob_t), t3)
        dsum = sum_d + sum_s
        p_d = torch.where(dsum > 0, sum_d / torch.where(dsum == 0, 1.0, dsum), 0.0)
        diffc = (p_d > 0) & (us[2] <= p_d)
        prob_d = torch.where(diffc, p_d, 1.0 - p_d)
        t3 = _where(survive & ~transmit, _scale(t3, 1.0 / prob_d), t3)

        m_trans = survive & transmit
        m_lam = survive & ~transmit & diffc
        m_ph = survive & ~transmit & ~diffc & (mexp > 0)
        m_mir = survive & ~transmit & ~diffc & (mexp <= 0)
        scatter = m_lam | m_ph | m_mir
        if counts is not None:
            counts["rays"] += active.sum()
            counts["shadow_rays"] += scatter.sum() * ((1 if one_light else L) if nee_on else 0)
            for key, m in (("hits", on_path), ("lambert", m_lam), ("phong", m_ph), ("mirror", m_mir),
                           ("transmit", m_trans)):
                counts[key] += m.sum()

        view = d
        tangent, binormal = tangent_frame(normal)
        refl = _reflect(view, normal)

        if nee_on:

            def nee_light(r, u1, u2, u3, scale):
                """One light's term: a solid-angle sample, its shadow ray and
                the weight scale / (pdf_b + pdf_l)."""
                rad = r[3]
                sx_ = rad * torch.sqrt(u1) * torch.cos(two_pi * u2)
                sy_ = rad * torch.sqrt(u1) * torch.sin(two_pi * u2)
                sz_ = _sqrt(rad * rad - sx_ * sx_ - sy_ * sy_) * torch.sin(pi * (u3 - 0.5))
                c = (r[0], r[1], r[2])
                dl = _normalize(_sub(_add(c, (sx_, sy_, sz_)), pos_hit))
                delta = _sub(c, pos_hit)
                dist = _sqrt(_dot(delta, delta))
                pdf_l = 1.0 / solid_angle(dist, rad)
                _, st_obj, _ = trace(_add(pos_hit, _scale(dl, eps)), dl)
                obj_id = r[7].to(torch.int64)
                visible = st_obj == obj_id
                not_self = obj != obj_id
                cosl = _dot(normal, dl)
                lobe_l = (mexp + 1.0) / two_pi * _pow(torch.clamp_min(_dot(refl, dl), 0.0), mexp)
                pdf_b_l = torch.where(m_lam, cosl / pi, torch.where(m_ph, lobe_l, 0.0))
                fcos_l = _where(
                    m_lam,
                    _scale(md, torch.clamp_min(cosl, 0.0) / pi),
                    _where(m_ph, _scale(ms, lobe_l * torch.clamp_min(cosl, 0.0)), (zf, zf, zf)),
                )
                ok = visible & not_self & (pdf_b_l != 0) & (pdf_l > 0)
                wl = torch.where(ok, scale / (pdf_b_l + pdf_l), 0.0)
                return _scale(_mul(fcos_l, (r[4], r[5], r[6])), wl)

            if one_light:
                li_v = torch.clamp_max((us[5] * float(L)).to(torch.int64), L - 1)
                rec = light_table[li_v]
                nee = nee_light([rec[:, f] for f in range(LIGHT_FLOATS)], us[6], us[7], us[8], const(L))
            else:
                nee = (zf, zf, zf)
                one = const(1.0)
                for li, r in enumerate(lights):
                    nee = _add(nee, nee_light(r, us[5 + 3 * li], us[6 + 3 * li], us[7 + 3 * li], one))
            r3 = add_term(r3, scatter, _mul(t3, nee))

        # the continuation's direction by each BSDF
        u1, u2 = us[3], us[4]
        cos_a = _dot(view, normal)
        entering = cos_a < 0
        n_eff = _where(entering, normal, _scale(normal, -1.0))
        eta = torch.where(entering, 1.0 / mior, mior)
        ci = _dot(view, n_eff)
        kk = 1.0 - eta * eta * (1.0 - ci * ci)
        refr = _sub(_scale(view, eta), _scale(n_eff, eta * ci + _sqrt(kk)))
        d_trans = _where(kk < 0, _reflect(view, n_eff), refr)
        rl = torch.sqrt(u1)
        phi = u2 * 2.0 * pi
        lz = _sqrt(1.0 - u1)
        d_lam = _add(
            _add(_scale(tangent, rl * torch.cos(phi)), _scale(binormal, rl * torch.sin(phi))), _scale(normal, lz)
        )
        pdf_lam = lz / pi
        uax = _cross((zf, zf, zf + 1.0), refl)
        degen = _dot(uax, uax) < 1e-12
        uax = _normalize(_where(degen, _cross((zf, zf + 1.0, zf), refl), uax))
        vax = _cross(uax, refl)
        cos_ph = _pow(u1, 1.0 / (mexp + 1.0))
        sin_ph = _sqrt(1.0 - cos_ph * cos_ph)
        d_ph = _add(
            _add(_scale(uax, sin_ph * torch.cos(phi)), _scale(vax, sin_ph * torch.sin(phi))), _scale(refl, cos_ph)
        )
        pdf_ph = (mexp + 1.0) / two_pi * _pow(cos_ph, mexp)

        new_d = _where(m_trans, d_trans, _where(m_lam, d_lam, _where(m_ph, d_ph, refl)))
        pdf_b = torch.where(m_lam, pdf_lam, torch.where(m_ph, pdf_ph, 1.0))
        cos_nd = _dot(normal, new_d)
        lobe_c = (mexp + 1.0) / two_pi * _pow(torch.clamp_min(_dot(refl, d_ph), 0.0), mexp)
        s_cont = torch.where(
            m_trans,
            1.0,
            torch.where(
                m_lam,
                torch.clamp_min(cos_nd, 0.0) / pi,
                torch.where(m_ph, lobe_c * torch.clamp_min(cos_nd, 0.0), torch.where(cos_nd > 0, 1.0, 0.0)),
            ),
        )
        fcos = tuple(m_ * s_cont for m_ in _where(m_lam, md, ms))

        t3 = _where(m_trans, _mul(t3, fcos), t3)
        r3 = add_term(r3, emitter, _mul(_where(survive, t3, tk), me))
        continuing = survive & (m_trans | (pdf_b != 0))
        if est.regen_threshold > 0.0:
            tmax = torch.maximum(torch.maximum(t3[0], t3[1]), t3[2])
            continuing = continuing & (tmax >= est.regen_threshold)

        # a finished path regenerates at the lane's next sample
        path_end = active & ~continuing
        new_sample = torch.where(path_end, sample + 1, sample)
        o_cam, d_cam = camera_ray(torch.clamp_max(new_sample, eff - 1))
        o = _where(continuing, _add(pos_hit, _scale(new_d, eps)), _where(path_end, o_cam, o))
        d = _where(continuing, new_d, _where(path_end, d_cam, d))
        t3 = _where(path_end, (zf + 1.0, zf + 1.0, zf + 1.0), t3)
        sc = scatter & ~path_end
        sample = new_sample
        depth = torch.where(path_end, 0, depth + 1)
        emit = path_end | torch.where(scatter, emit_after_scatter, emit)
        misp = sc
        ppdf = torch.where(sc, pdf_b, 1.0)
        pfcos = tuple(torch.where(sc, f, 1.0) for f in fcos)
        pdelta = m_mir & ~path_end
        prev_obj = torch.where(sc, obj, -1)
        prev_pos = tuple(torch.where(sc, p, 0.0) for p in pos_hit)

    if counts is not None:
        for key, v in counts.items():
            stats[key] = stats.get(key, 0) + int(v)
    return torch.stack(r3).to(torch.float32).reshape(3, len(seeds), n_pix).transpose(0, 1)


def batch_image(
    scene: PackedScene,
    seed: int,
    first_pass: int,
    n_passes: int,
    width: int,
    height: int,
    spp: int,
    est: Estimator,
    dtype=torch.float32,
    stats: dict | None = None,
) -> torch.Tensor:
    """The sum of passes ``first_pass`` .. ``first_pass + n_passes - 1`` of a
    render seeded with ``seed`` -> [H, W, 4] float32 on the scene's device.
    Each pass's image is its sums divided by spp (eff samples taken, the
    kajo quirk) or by eff, with alpha 1, added in pass order."""
    seeds = [pass_seed(seed, first_pass + i) for i in range(n_passes)]
    sums = trace_lanes(scene, seeds, width, height, spp, est, dtype, stats)
    eff = max(int(spp**0.5), 1) ** 2
    divisor = sums.new_tensor(float(spp if est.kajo_spp_quirk else eff))
    total = torch.zeros((height, width, 4), dtype=torch.float32, device=sums.device)
    for i in range(n_passes):
        img = torch.zeros((width * height, 4), dtype=torch.float32, device=sums.device)
        img[:, :3] = sums[i].T / divisor
        img[:, 3] = 1.0
        total += img.reshape(height, width, 4)
    return total
