"""Regenerating wavefront renderer, the ``fast`` engine (port of
``kajo_tpu/models/wavefront.py``).

The same estimator as the megakernel's lane loop, written as tensor code
over all lanes at once: each iteration traces every live lane's ray, shades
the hit (Russian roulette, the 4-BSDF lottery, NEE over all lights or one,
the deferred MIS weight, emission, background) and picks the next ray. A
lane whose path ends starts its next stratified sample at once
(regeneration), and the loop runs until every lane has taken its samples,
so per-pixel sample counts are exact. Random numbers are the JAX package's
PCG4D streams addressed by (lane, sample, salt, seed), so for the same u32
seed the two packages trace the same paths.

Scenes above ``geometry.STREAM_THRESHOLD`` spheres trace through the
streaming kernels (K5 nearest hit, K6 shadow occlusion; CUDA on a GPU, the
plain versions on the CPU). For them each pixel's samples are split across
``LANE_MULT`` lanes, which cuts the iterations by that factor, and lanes
walk the image in ``TILE_TS``-square screen tiles, so the rays of one CTA
are neighbours and cull the same sphere blocks.

The JAX ``lax.while_loop`` is a Python loop here; its ``any()`` test reads
one flag back from the device per iteration. On a CUDA device
:func:`render_passes_fast` captures the loop's body as a CUDA graph once
(again only when the scene's layout, the sizes or the config change) and
replays it at each iteration (:class:`_GraphedLoop`): the same kernels,
one launch from the host in place of several hundred.

Spans and counters of the loop: ``torch.profiler`` ranges
``kajo.wavefront.prepare`` (the scene's preparation in
:func:`render_passes_fast`), ``kajo.wavefront.iteration`` (each run of the
loop's body) and ``kajo.wavefront.flag`` (each read of the loop's flag);
the module counters ``iterations`` and ``flag_reads`` count those bodies
and reads, and ``prepare_seconds`` sums the host's seconds inside that
preparation, as ``ops/stream_trace.py``'s ``nearest_launches`` counts K5.

The differentiable budget engine (``render_lanes_budget``,
``render_pass_budget``) runs the same body a fixed
``BUDGET_ITERS_PER_SAMPLE * eff_spp`` times, with no flag read back, one
lane per pixel on dense and streamed scenes alike. Samples still in flight
at the end are discarded and each pixel is divided by the samples it
completed (a ratio estimator). Each iteration runs under
``torch.utils.checkpoint`` (non-reentrant, which carries gradients to the
prepared scene the body closes over), so the backward recomputes an
iteration instead of keeping every iteration's graph. The branch
probabilities (roulette, lottery) are detached, as in the JAX package. Its
traces are differentiable on streamed scenes too, through the nearest
hit's VJP (``ops/stream_trace.py``). The TPU tuning knobs (wavefront
reordering, ray sorting) are not ported.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from ..ops import bsdf, lights, sampling, stream_trace
from ..ops.geometry import PreparedScene, generate_rays, light_visible, prepare_scene, trace
from ..ops.rng import as_key, pass_seed, uniforms4
from ..scene.types import Scene
from .integrator import RenderConfig

CAMERA_SALT = 0x7FFFFFFF
# lanes per pixel on streamed scenes (when eff_spp divides; else 2, else 1)
LANE_MULT = 4
# screen-tile edge of the lane -> pixel order on streamed scenes
TILE_TS = 64
# iterations of the budget engine per effective sample
BUDGET_ITERS_PER_SAMPLE = 4

iterations = 0  # runs of the loop's body
flag_reads = 0  # reads of the loop's flag back from the device
prepare_seconds = 0.0  # host seconds preparing the scene in render_passes_fast


def tiled_pixel_order(width: int, height: int) -> np.ndarray:
    """Lane -> pixel id, walking the image in TILE_TS x TILE_TS screen tiles
    (row-major tiles, row-major inside a tile) -> uint32 [W*H]."""
    ts = TILE_TS
    xs, ys = np.meshgrid(np.arange(width), np.arange(height))
    tiles_x = -(-width // ts)
    tile_id = (ys // ts) * tiles_x + (xs // ts)
    within = (ys % ts) * ts + (xs % ts)
    return np.argsort((tile_id * (ts * ts) + within).ravel(), kind="stable").astype(np.uint32)


def _camera_ray(prep, lane, pix, sample, seed, width, height, grid):
    """Stratified camera ray of ``sample`` for pixel ``pix``; the random
    stream is keyed by ``lane``."""
    px = (pix % width).to(torch.float32)
    py = (pix // width).to(torch.float32)
    gx = (sample % grid).to(torch.float32)
    gy = (sample // grid).to(torch.float32)
    u1, u2, _, _ = uniforms4(lane, sample, CAMERA_SALT, seed)
    sx = (px + (gx + u1) / grid) / width
    sy = ((height - py) + (gy + u2) / grid) / height
    return generate_rays(prep.camera, sx, sy)


def _nee3(prep, hit, mat, u_l, m_lambert, m_phong, eps, trace_fn=trace):
    """NEE over every emissive sphere, RGB; ``u_l``: [3, N, L] uniforms."""
    num_l = prep.light_obj.shape[0]
    n = hit.position.shape[0]
    pos = hit.position[:, None, :]
    center = prep.light_center[None, :, :]
    radius = prep.light_radius[None, :]
    dir_l, pdf_l = lights.sample(u_l[0], u_l[1], u_l[2], center, radius, pos)
    not_self = hit.obj[:, None] != prep.light_obj[None, :]
    normal = hit.normal[:, None, :]
    view = hit.view[:, None, :]
    exp = mat["specular_exponent"][:, None]
    pdf_b = torch.where(
        m_lambert[:, None],
        bsdf.lambert_pdf(normal, dir_l),
        torch.where(m_phong[:, None], bsdf.phong_pdf(view, normal, dir_l, exp), 0.0),
    )
    fcos = torch.where(
        m_lambert[:, None, None],
        bsdf.lambert_eval_cos(mat["diffuse"][:, None, :], normal, dir_l),
        torch.where(
            m_phong[:, None, None],
            bsdf.phong_eval_cos(mat["specular"][:, None, :], view, normal, dir_l, exp),
            0.0,
        ),
    )
    # lanes whose term is zero whatever the visibility skip the shadow search
    needed = not_self & (pdf_b != 0) & (pdf_l > 0) & (m_lambert | m_phong)[:, None]
    visible = light_visible(
        prep,
        (pos + dir_l * eps).reshape(n * num_l, 3),
        dir_l.reshape(n * num_l, 3),
        center.expand(n, num_l, 3).reshape(n * num_l, 3),
        radius.expand(n, num_l).reshape(n * num_l),
        prep.light_obj[None, :].expand(n, num_l).reshape(n * num_l),
        needed.reshape(n * num_l),
        trace_fn,
    ).reshape(n, num_l)
    ok = visible & not_self & (pdf_b != 0) & (pdf_l > 0)
    weight = torch.where(ok, 1.0 / (pdf_b + pdf_l), 0.0)
    return torch.sum(weight[..., None] * fcos * prep.light_emission[None, :, :3], 1)


def _nee3_one_light(prep, hit, mat, u_sel, u3, m_lambert, m_phong, eps, trace_fn=trace):
    """One-of-L NEE: one uniformly chosen light per lane, its term (with its
    own MIS weight 1/(pdf_b + pdf_l)) scaled by L; one shadow ray per
    vertex."""
    num_l = prep.light_obj.shape[0]
    li = torch.clamp_max((u_sel * num_l).to(torch.int64), num_l - 1)
    center = prep.light_center[li]
    radius = prep.light_radius[li]
    lobj = prep.light_obj[li]
    emission = prep.light_emission[li, :3]

    pos = hit.position
    dir_l, pdf_l = lights.sample(u3[0], u3[1], u3[2], center, radius, pos)
    not_self = hit.obj != lobj
    exp = mat["specular_exponent"]
    pdf_b = torch.where(
        m_lambert,
        bsdf.lambert_pdf(hit.normal, dir_l),
        torch.where(m_phong, bsdf.phong_pdf(hit.view, hit.normal, dir_l, exp), 0.0),
    )
    fcos = torch.where(
        m_lambert[:, None],
        bsdf.lambert_eval_cos(mat["diffuse"], hit.normal, dir_l),
        torch.where(m_phong[:, None], bsdf.phong_eval_cos(mat["specular"], hit.view, hit.normal, dir_l, exp), 0.0),
    )
    needed = not_self & (pdf_b != 0) & (pdf_l > 0) & (m_lambert | m_phong)
    visible = light_visible(prep, pos + dir_l * eps, dir_l, center, radius, lobj, needed, trace_fn)
    ok = visible & not_self & (pdf_b != 0) & (pdf_l > 0)
    weight = torch.where(ok, num_l / (pdf_b + pdf_l), 0.0)
    return weight[:, None] * fcos * emission


def _light_pdf_for_hit3(prep, hit_obj, prev_obj, prev_pos):
    """MIS light pdf of the light a BSDF ray hit, seen from its origin."""
    if prep.light_obj.shape[0] == 0:
        return torch.zeros(hit_obj.shape, dtype=torch.float32, device=hit_obj.device)
    is_light = hit_obj[:, None] == prep.light_obj[None, :]
    not_self = prev_obj[:, None] != prep.light_obj[None, :]
    pdf = lights.pdf(prep.light_center[None, :, :], prep.light_radius[None, :], prev_pos[:, None, :])
    return torch.sum(torch.where(is_light & not_self, pdf, 0.0), 1)


def _make_loop(prep: PreparedScene, lane, seed, width, height, eff_spp, grid, config: RenderConfig, pix=None,
               sample_lo=None, sample_hi=None, trace_fn=trace):
    """(initial state, cond, body) of the regenerating wavefront.

    Radiance is split into ``radiance`` (completed samples, folded in at
    path end) and ``r_cur`` (the sample in flight). Each lane walks the
    samples [sample_lo, sample_hi) (default [0, eff_spp)): the lane
    multiplier splits a pixel's samples across lanes with distinct stream
    keys. ``iters`` counts iterations and ``rays`` live-lane traces (one
    path ray per live lane, plus the shadow rays of scattering lanes).
    ``trace_fn`` (``trace``'s signature) answers every nearest hit; one
    other than ``trace`` also answers the shadow rays (see
    ``geometry.light_visible``)."""
    n = lane.shape[0]
    dev = lane.device
    pix = lane if pix is None else pix
    s_lo = torch.zeros(n, dtype=torch.int64, device=dev) if sample_lo is None else sample_lo
    s_hi = torch.full((n,), eff_spp, dtype=torch.int64, device=dev) if sample_hi is None else sample_hi
    num_lights = prep.light_obj.shape[0]
    eps = config.surface_epsilon
    m = prep.materials
    mat3 = {
        "diffuse": m.diffuse[:, :3],
        "specular": m.specular[:, :3],
        "emission": m.emission[:, :3],
        "transparency": m.transparency[:, :3],
        "specular_exponent": m.specular_exponent,
        "refractive_index": m.refractive_index,
    }
    bg = prep.background[:3]
    emit_after_scatter = (not config.direct_lighting) or config.full_mis
    # the GL backend's exact estimator: emission on the first vertex only,
    # no roulette, the throughput cull after the deferred weight, no
    # background on a miss
    gl = bool(config.gl_semantics)
    gl_cull = config.regen_threshold if config.regen_threshold > 0.0 else 0.01
    # shadow rays per scattering lane, for the ray count
    nee_rays = 0 if not config.direct_lighting else (1 if config.one_light_nee and num_lights > 1 else num_lights)

    o0, d0 = _camera_ray(prep, lane, pix, s_lo, seed, width, height, grid)
    zf = torch.zeros(n, dtype=torch.float32, device=dev)
    state = dict(
        sample=s_lo,
        depth=torch.zeros(n, dtype=torch.int64, device=dev),
        o=o0,
        d=d0,
        throughput=torch.ones((n, 3), dtype=torch.float32, device=dev),
        radiance=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        emit=torch.ones(n, dtype=torch.bool, device=dev),
        mis_pending=torch.zeros(n, dtype=torch.bool, device=dev),
        pend_pdf_b=zf + 1.0,
        pend_fcos=torch.ones((n, 3), dtype=torch.float32, device=dev),
        pend_delta=torch.zeros(n, dtype=torch.bool, device=dev),
        prev_obj=torch.full((n,), -1, dtype=torch.int64, device=dev),
        prev_pos=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        r_cur=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        iters=0,
        # live-lane ray count, accumulated on the device (f32, as the JAX
        # counter: int32 would overflow at realistic sizes)
        rays=torch.zeros((), dtype=torch.float32, device=dev),
    )

    # PCG4D calls per vertex; one-light NEE needs 4 NEE uniforms whatever L
    n_uni = max(5 + 3 * num_lights, 9 if config.one_light_nee else 0)
    ncalls = -(-n_uni // 4)

    def cond(state):
        global flag_reads
        with record_function("kajo.wavefront.flag"):
            flag_reads += 1
            return bool((state["sample"] < s_hi).any())

    def step(state):
        active = state["sample"] < s_hi
        sample = state["sample"]
        depth = state["depth"]
        salt0 = depth * ncalls
        us = []
        for i in range(ncalls):
            us.extend(uniforms4(lane, sample, salt0 + i, seed))
        # us[0] roulette, us[1] transmit coin, us[2] diffuse coin, us[3..4]
        # BSDF sample, us[5:5+3L] NEE

        hit = trace_fn(prep, state["o"], state["d"])
        was_hit = hit.obj >= 0
        t = state["throughput"]
        r = state["r_cur"]

        # deferred MIS weight of the previous vertex. GL: no not-self test,
        # and the mirror continuation carries no light pdf
        prev_obj = torch.full_like(state["prev_obj"], -1) if gl else state["prev_obj"]
        pdf_l_vis = _light_pdf_for_hit3(prep, hit.obj, prev_obj, state["prev_pos"])
        if config.full_mis or gl:
            pdf_l_vis = torch.where(state["pend_delta"], 0.0, pdf_l_vis)
        denom = pdf_l_vis + state["pend_pdf_b"]
        weight = state["pend_fcos"] / torch.where(denom == 0, 1.0, denom)[:, None]
        t = torch.where((state["mis_pending"] & active)[:, None], t * weight, t)

        # GL's post-shade cull: after the deferred weight, before any of
        # this vertex's contributions; the lane regenerates below
        active_v = active & ~(torch.max(t, -1).values < gl_cull) if gl else active

        # a miss ends the path (the GL pipeline adds no background)
        miss = active_v & ~was_hit
        if not gl:
            r = r + torch.where(miss[:, None], t * bg[None, :], 0.0)
        on_path = active_v & was_hit

        obj = torch.clamp_min(hit.obj, 0)
        mat = {k: v[obj] for k, v in mat3.items()}

        # Russian roulette and the depth limit (GL: no roulette; us[0] is
        # drawn all the same, keeping the stream layout)
        if gl:
            cont = torch.ones_like(on_path)
        else:
            p_rr = torch.max(torch.maximum(torch.maximum(mat["diffuse"], mat["specular"]), mat["transparency"]), -1).values
            cont, prob_rr = sampling.flip_coin(us[0], p_rr.detach())
            t = torch.where(on_path[:, None], t / prob_rr[:, None], t)
        t_kill = t
        emitter = on_path & ((depth == 0) if gl else state["emit"])
        survive = on_path & cont & (depth < config.max_depth)

        # BSDF lottery
        sum_d = torch.sum(mat["diffuse"], -1)
        sum_s = torch.sum(mat["specular"], -1)
        sum_t = torch.sum(mat["transparency"], -1)
        total = sum_d + sum_s + sum_t
        p_t = torch.where(total > 0, sum_t / torch.where(total == 0, 1.0, total), 0.0)
        transmit, prob_t = sampling.flip_coin(us[1], p_t.detach())
        t = torch.where(survive[:, None], t / prob_t[:, None], t)
        ds = sum_d + sum_s
        p_d = torch.where(ds > 0, sum_d / torch.where(ds == 0, 1.0, ds), 0.0)
        diff, prob_d = sampling.flip_coin(us[2], p_d.detach())
        t = torch.where((survive & ~transmit)[:, None], t / prob_d[:, None], t)

        m_transmit = survive & transmit
        m_lambert = survive & ~transmit & diff
        m_phong = survive & ~transmit & ~diff & (mat["specular_exponent"] > 0)
        m_mirror = survive & ~transmit & ~diff & (mat["specular_exponent"] <= 0)
        scatter = m_lambert | m_phong | m_mirror

        if config.direct_lighting and num_lights:
            if config.one_light_nee and num_lights > 1:
                nee = _nee3_one_light(prep, hit, mat, us[5], (us[6], us[7], us[8]), m_lambert, m_phong, eps,
                                      trace_fn)
            else:
                # light l's k-th uniform is us[5 + k * L + l]
                u_l = torch.stack(us[5 : 5 + 3 * num_lights]).reshape(3, num_lights, n).permute(0, 2, 1)
                nee = _nee3(prep, hit, mat, u_l, m_lambert, m_phong, eps, trace_fn)
            r = r + torch.where(scatter[:, None], t * nee, 0.0)

        # continuation
        d_trans, _ = bsdf.transmission_sample(hit.view, hit.normal, mat["refractive_index"])
        d_lam, pdf_lam = bsdf.lambert_sample(us[3], us[4], hit.tangent, hit.binormal, hit.normal)
        d_ph, pdf_ph = bsdf.phong_sample(us[3], us[4], hit.view, hit.normal, mat["specular_exponent"])
        d_mir, _ = bsdf.reflector_sample(hit.view, hit.normal)
        new_d = torch.where(
            m_transmit[:, None],
            d_trans,
            torch.where(m_lambert[:, None], d_lam, torch.where(m_phong[:, None], d_ph, d_mir)),
        )
        pdf_b = torch.where(m_lambert, pdf_lam, torch.where(m_phong, pdf_ph, 1.0))
        fcos = torch.where(
            m_transmit[:, None],
            bsdf.transmission_eval_abscos(mat["specular"], hit.normal, d_trans),
            torch.where(
                m_lambert[:, None],
                bsdf.lambert_eval_cos(mat["diffuse"], hit.normal, d_lam),
                torch.where(
                    m_phong[:, None],
                    bsdf.phong_eval_cos(mat["specular"], hit.view, hit.normal, d_ph, mat["specular_exponent"]),
                    bsdf.reflector_eval_cos(mat["specular"], hit.normal, d_mir),
                ),
            ),
        )

        t = torch.where(m_transmit[:, None], t * fcos, t)
        r = r + torch.where(emitter[:, None], torch.where(survive[:, None], t, t_kill) * mat["emission"], 0.0)
        continuing = survive & (m_transmit | (pdf_b != 0))
        if config.regen_threshold > 0.0 and not gl:
            # throughput cull (biased; 0 keeps the exact estimator)
            continuing = continuing & (torch.max(t, -1).values >= config.regen_threshold)

        # regeneration: an ended path starts the lane's next sample
        path_end = active & ~continuing
        new_sample = torch.where(path_end, sample + 1, sample)
        o_cam, d_cam = _camera_ray(prep, lane, pix, torch.minimum(new_sample, s_hi - 1), seed, width, height, grid)
        cont3, end3 = continuing[:, None], path_end[:, None]
        sc = scatter & ~path_end
        return dict(
            sample=new_sample,
            depth=torch.where(path_end, 0, depth + 1),
            o=torch.where(cont3, hit.position + new_d * eps, torch.where(end3, o_cam, state["o"])),
            d=torch.where(cont3, new_d, torch.where(end3, d_cam, state["d"])),
            throughput=torch.where(end3, 1.0, t),
            radiance=state["radiance"] + torch.where(end3, r, 0.0),
            r_cur=torch.where(end3, 0.0, r),
            emit=path_end | torch.where(scatter, emit_after_scatter, state["emit"]),
            mis_pending=~path_end & scatter,
            pend_pdf_b=torch.where(sc, pdf_b, 1.0),
            pend_fcos=torch.where(sc[:, None], fcos, 1.0),
            pend_delta=m_mirror & ~path_end,
            prev_obj=torch.where(sc, hit.obj, -1),
            prev_pos=torch.where(sc[:, None], hit.position, 0.0),
            iters=state["iters"] + 1,
            rays=state["rays"] + active.sum() + scatter.sum() * nee_rays,
        )

    return state, cond, _counted(step)


def _counted(step):
    """``step`` as the loop's body: each run counted in ``iterations`` and
    spanned ``kajo.wavefront.iteration``; ``body.step`` is ``step``."""

    def body(state):
        global iterations
        with record_function("kajo.wavefront.iteration"):
            iterations += 1
            return step(state)

    body.step = step
    return body


def render_lanes(prep, lane, seed, width, height, eff_spp, grid, config, pix=None, sample_lo=None, sample_hi=None,
                 trace_fn=trace):
    """Run the wavefront until every lane has taken its samples ->
    (radiance sums [N, 3], iterations, rays traced as a 0-d tensor).
    ``trace_fn`` answers the nearest hits (``trace`` by default)."""
    state, cond, body = _make_loop(prep, lane, seed, width, height, eff_spp, grid, config, pix, sample_lo, sample_hi,
                                   trace_fn)
    while cond(state):
        state = body(state)
    return state["radiance"], state["iters"], state["rays"]


def _seed_tensor(seed: int, device) -> torch.Tensor:
    return torch.tensor(seed & 0xFFFFFFFF, dtype=torch.int64, device=device)


def lane_layout(prep: PreparedScene, width: int, height: int, eff: int):
    """The lanes of one pass -> (lane, pix, sample_lo, sample_hi, pixmap).

    Dense scenes: one lane per pixel, lane = pixel. Streamed scenes: lanes
    walk the image in screen tiles (``pixmap``, lane -> pixel), and each
    pixel's ``eff`` samples are split across ``mult`` lanes (LANE_MULT, else
    2, where it divides ``eff``): lane l + k*n renders pixel pixmap[l],
    samples [k*eff/mult, (k+1)*eff/mult)."""
    dev = prep.background.device
    n = width * height
    streamed = prep.stream_packed is not None
    mult = next((m for m in (LANE_MULT, 2) if eff % m == 0), 1) if streamed else 1
    lane = torch.arange(n * mult, dtype=torch.int64, device=dev)
    if not streamed:
        return lane, lane, None, None, None
    pixmap = torch.from_numpy(tiled_pixel_order(width, height).astype(np.int64)).to(dev)
    k = eff // mult
    s_lo = (lane // n) * k
    return lane, pixmap[lane % n], s_lo, s_lo + k, pixmap


# device index -> the last graphed loop, reused while the scene's
# preparation keeps its layout and the sizes and config stay
_LOOPS = {}


def _fields(obj, prefix=""):
    """(name, value) of each field of a prepared scene, the nested
    dataclasses' fields under dotted names."""
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            yield from _fields(v, f"{prefix}{f.name}.")
        else:
            yield prefix + f.name, v


def _cloned(obj):
    """A prepared scene with a copy of each tensor of its own."""
    return dataclasses.replace(obj, **{
        f.name: _cloned(v) if dataclasses.is_dataclass(v) else v.clone() if isinstance(v, torch.Tensor) else v
        for f in dataclasses.fields(obj) for v in (getattr(obj, f.name),)
    })


def _layout(prep: PreparedScene) -> tuple:
    """What a graph captured on ``prep`` holds fixed: each tensor's shape,
    dtype and device, and every other field's value."""
    return tuple((k, (v.shape, v.dtype, v.device) if isinstance(v, torch.Tensor) else v) for k, v in _fields(prep))


def _graphed_loop(prep: PreparedScene, width: int, height: int, spp: int, config: RenderConfig):
    """The device's :class:`_GraphedLoop` for ``prep``'s layout, the sizes
    and the config: the last one, its preparation refilled from ``prep``,
    where all of those match, else a new one."""
    key = (_layout(prep), width, height, spp, config)
    dev = prep.background.device.index
    last = _LOOPS.get(dev)
    if last is not None and last.key == key:
        for (_, mine), (_, new) in zip(_fields(last.prep), _fields(prep)):
            if isinstance(mine, torch.Tensor):
                mine.copy_(new)
        return last
    _LOOPS[dev] = _GraphedLoop(prep, width, height, spp, config, key, last)
    return _LOOPS[dev]


class _GraphedLoop:
    """The wavefront's loop on a CUDA device, the body captured once as a
    CUDA graph and replayed at each iteration.

    The body is several hundred small kernels over every lane; launched one
    by one from Python, they kept the host the slower side (at 512x384, 4
    spp, 786,432 lanes, the card idled two thirds of a batch). The first
    iteration runs eagerly, which loads every kernel, and the capture
    follows. The graph reads the preparation (the loop's own copy, which
    each batch refills), the lane layout, the pass seed and the loop's
    state from fixed buffers and writes the state back into them, so a pass
    refills the seed and the state and replays until the flag, read as
    before, says every lane is done. The kernels and their inputs are the
    eager loop's, and so are the bits. A replay counts as a body in
    ``iterations`` and adds its K5/K6 runs to ``stream_trace``'s counters."""

    def __init__(self, prep: PreparedScene, width: int, height: int, spp: int, config: RenderConfig, key: tuple,
                 last: "_GraphedLoop" = None):
        self.prep, self.width, self.height, self.config, self.key = _cloned(prep), width, height, config, key
        self.grid = max(int(spp**0.5), 1)
        self.layout = lane_layout(self.prep, width, height, self.grid * self.grid)
        self.seed = _seed_tensor(0, prep.background.device)
        self.graph = self.buffers = None
        # the last loop's graph, alive until this capture joins its memory
        # pool (a pool lives while a graph holds it)
        self.last_graph = None if last is None else last.graph
        self.launches = (0, 0)  # K5 and K6 runs of a replay
        self.body = _counted(self._replay)

    def __call__(self, seed: int):
        """The loop of the pass seeded ``seed`` -> (radiance sums [N, 3],
        iterations, rays traced as a 0-d tensor)."""
        lane, pix, s_lo, s_hi, _ = self.layout
        self.seed.fill_(seed & 0xFFFFFFFF)
        state, cond, body = _make_loop(self.prep, lane, self.seed, self.width, self.height, self.grid**2, self.grid,
                                       self.config, pix, s_lo, s_hi)
        if self.graph is None:
            if not cond(state):
                return state["radiance"], state["iters"], state["rays"]
            state = body(state)
            self._capture(body.step, state)
        else:
            for k, buf in self.buffers.items():
                buf.copy_(state[k])
        state = {**self.buffers, "iters": state["iters"]}
        while cond(state):
            state = self.body(state)
        return state["radiance"].clone(), state["iters"], state["rays"].clone()

    def _capture(self, step, state):
        """Capture ``step`` on ``state``'s tensors, which become the buffers."""
        dev = self.seed.device
        self.buffers = {k: v for k, v in state.items() if isinstance(v, torch.Tensor)}
        before = (stream_trace.nearest_launches, stream_trace.occluded_launches)
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            graph.capture_begin(pool=None if self.last_graph is None else self.last_graph.pool())
            try:
                out = step({**self.buffers, "iters": 0})
                for k, buf in self.buffers.items():
                    buf.copy_(out[k])
                del out  # freed inside the capture, so a later capture reuses its memory
            finally:
                graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        # the capture ran no kernel: its launches count at each replay
        self.launches = (stream_trace.nearest_launches - before[0], stream_trace.occluded_launches - before[1])
        stream_trace.nearest_launches, stream_trace.occluded_launches = before
        self.graph, self.last_graph = graph, None

    def _replay(self, state):
        self.graph.replay()
        stream_trace.nearest_launches += self.launches[0]
        stream_trace.occluded_launches += self.launches[1]
        return {**self.buffers, "iters": state["iters"] + 1}


def _pass(prep: PreparedScene, seed: int, width: int, height: int, spp: int, config: RenderConfig,
          loop: _GraphedLoop = None):
    """One wavefront pass of a prepared scene -> ([H, W, 4], iterations,
    rays). ``loop``: a :class:`_GraphedLoop` of the same scene, sizes and
    config, which runs the loop in place of :func:`render_lanes`."""
    dev = prep.background.device
    grid = max(int(spp**0.5), 1)
    eff = grid * grid
    divisor = float(spp if config.kajo_spp_quirk else eff)
    n = width * height
    if loop is None:
        lane, pix, s_lo, s_hi, pixmap = lane_layout(prep, width, height, eff)
        rgb, iters, rays = render_lanes(prep, lane, _seed_tensor(seed, dev), width, height, eff, grid, config, pix,
                                        s_lo, s_hi)
    else:
        pixmap = loop.layout[4]
        rgb, iters, rays = loop(seed)
    if pixmap is not None:
        # sum a pixel's lanes in a fixed order (no atomics), then place them
        rgb = rgb.reshape(-1, n, 3).sum(0)
        rgb = torch.zeros_like(rgb).index_copy_(0, pixmap, rgb)
    img = torch.cat([rgb / divisor, torch.ones((n, 1), dtype=torch.float32, device=dev)], 1)
    return img.reshape(height, width, 4), iters, rays


def render_pass_fast(scene: Scene, seed: int, width: int, height: int, spp: int,
                     config: RenderConfig = RenderConfig()) -> torch.Tensor:
    """One progressive pass with u32 pass seed ``seed`` -> [H, W, 4] on the
    scene's device."""
    return _pass(prepare_scene(scene), seed, width, height, spp, config)[0]


def render_passes_fast(scene: Scene, seed: int, pass_offset: int, width: int, height: int, spp: int,
                       n_passes: int, config: RenderConfig = RenderConfig()) -> torch.Tensor:
    """Sum of ``n_passes`` passes on the scene's device, the scene prepared
    once; pass i uses the seed ``pass_seed(seed, pass_offset + i)``. On a
    CUDA device, where no tensor of the scene needs a gradient, the loop's
    body runs as a CUDA graph (:func:`_graphed_loop`)."""
    global prepare_seconds
    t0 = time.perf_counter()
    with record_function("kajo.wavefront.prepare"):
        prep = prepare_scene(scene)
    prepare_seconds += time.perf_counter() - t0
    total = torch.zeros((height, width, 4), dtype=torch.float32, device=scene.device)
    graphed = total.device.type == "cuda" and not any(
        isinstance(v, torch.Tensor) and v.requires_grad for _, v in _fields(prep))
    loop = _graphed_loop(prep, width, height, spp, config) if graphed else None
    for i in range(n_passes):
        total += _pass(prep, pass_seed(seed, pass_offset + i), width, height, spp, config, loop)[0]
    return total


def render_pass_fast_stats(scene: Scene, seed: int, width: int, height: int, spp: int,
                           config: RenderConfig = RenderConfig()):
    """:func:`render_pass_fast` and its counters -> (image, iterations, rays
    traced). The rays count live-lane traces: one path ray per live lane per
    iteration, plus the shadow rays of scattering lanes."""
    img, iters, rays = _pass(prepare_scene(scene), seed, width, height, spp, config)
    return img, iters, float(rays)


def render_image_fast(scene: Scene, width: int, height: int, spp: int, key, passes: int = 1,
                      config: RenderConfig = RenderConfig()) -> torch.Tensor:
    """The mean of ``passes`` wavefront passes, the scene prepared once ->
    [H, W, 4]. ``key`` is a u32 seed or a key (``ops/rng.py``); pass p
    renders with ``key.fold_in(p).seed()``, as the JAX package's pass p
    takes ``seed_from_key(fold_in(key, p))``."""
    key = as_key(key)
    prep = prepare_scene(scene)
    total = torch.zeros((height, width, 4), dtype=torch.float32, device=scene.device)
    for p in range(passes):
        total = total + _pass(prep, key.fold_in(p).seed(), width, height, spp, config)[0]
    return total / passes


def render_lanes_budget(prep, lane, seed, width, height, eff_spp, grid, config, n_iters):
    """The regenerating body run exactly ``n_iters`` times -> (radiance sums
    of the completed samples [N, 3], completed samples [N]).

    Samples still in flight at the end are discarded (their radiance never
    reaches ``radiance``), so each lane's estimate stays unbiased per
    completed sample; lanes complete slightly different counts. Each
    iteration runs under a non-reentrant checkpoint (jax.checkpoint in the
    JAX package), so the backward recomputes it instead of keeping its
    graph: only the non-reentrant form carries gradients to the prepared
    scene the body closes over."""
    state, _, body = _make_loop(prep, lane, seed, width, height, eff_spp, grid, config)
    for _ in range(n_iters):
        state = checkpoint(body, state, use_reentrant=False, preserve_rng_state=False)
    return state["radiance"], torch.clamp_max(state["sample"], eff_spp)


def render_pass_budget(scene: Scene, seed: int, width: int, height: int, spp: int,
                       config: RenderConfig = RenderConfig()) -> torch.Tensor:
    """Differentiable wavefront pass with u32 pass seed ``seed`` -> [H, W, 4].

    ``BUDGET_ITERS_PER_SAMPLE * eff_spp`` iterations, one lane per pixel (lane =
    pixel, samples [0, eff_spp)); with Russian-roulette paths of 2-3
    vertices they complete nearly every sample. Each pixel is divided by
    max(completed, 1) times the spp quirk (spp / eff_spp with
    ``kajo_spp_quirk``), so a pixel that completed all its samples equals
    :func:`render_pass_fast`'s on a dense scene bit for bit."""
    dev = scene.device
    prep = prepare_scene(scene)
    grid = max(int(spp**0.5), 1)
    eff = grid * grid
    quirk = float(spp if config.kajo_spp_quirk else eff) / eff
    n = width * height
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    rgb, completed = render_lanes_budget(prep, lane, _seed_tensor(seed, dev), width, height, eff, grid, config,
                                         BUDGET_ITERS_PER_SAMPLE * eff)
    denom = torch.clamp_min(completed, 1).to(torch.float32) * quirk
    img = torch.cat([rgb / denom[:, None], torch.ones((n, 1), dtype=torch.float32, device=dev)], 1)
    return img.reshape(height, width, 4)
