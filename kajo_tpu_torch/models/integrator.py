"""The parity engine: a fixed-depth Monte-Carlo path tracer with multiple
importance sampling, port of ``kajo_tpu/models/integrator.py``.

The reference's recursive estimator (its CPU backend) as a wavefront over
bounces: every bounce traces all lanes' rays, shades the hits and picks the
next rays, ``max_depth + 1`` times. Its semantics are the JAX module's, line
for line: background on a miss; emission only while a lane's ``emit`` flag
is set; Russian roulette from depth 0 that also weights the local emission;
the one-sample BSDF lottery (transparency coin, then diffuse coin); NEE over
the emissive spheres, or one of them (``one_light_nee``), with one-sample
balance-heuristic weights; the continuation weighted 1/(pdf_light +
pdf_bsdf) at the next vertex; the GL backend's estimator under
``gl_semantics``. The discrete branch probabilities are detached, as JAX's
are under ``stop_gradient``.

It runs no kernel of its own: plain PyTorch on the scene's device, tracing
through ``ops/geometry.py`` (dense, or the streaming kernels K5 above
``STREAM_THRESHOLD`` spheres on a GPU). The JAX ``lax.scan`` over bounces is
a Python loop that stops once every lane's path has ended, which changes no
value. Draws go through a key (``ops/rng.py``: ``CounterKey`` for a u32
seed, or any object with its ``fold_in``/``split``/``uniform``), so the
uniforms of each bounce and stratum are the JAX module's for the same key.

``RenderConfig`` keeps the JAX package's fields, defaults and ``repr`` (the
CLI's checkpoint metadata compares that ``repr``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import bsdf, lights, sampling
from ..ops.geometry import PreparedScene, generate_rays, prepare_scene, trace
from ..ops.rng import as_key, uniform_columns
from ..scene.types import Materials, Scene


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Estimator knobs (reference hardcodes: depth 8, ε=1e-3, NEE on)."""

    max_depth: int = 8
    surface_epsilon: float = 1e-3
    direct_lighting: bool = True
    # True keeps the emit flag set after a scattering bounce: the deferred
    # 1/(pdf_light + pdf_bsdf) continuation weight then completes the
    # one-sample balance-heuristic MIS; False (kajo parity) drops the
    # BSDF-sampled half, as the reference does once NEE is on.
    full_mis: bool = False
    # kajo divides the per-pass sum by spp while taking only floor(sqrt(spp))²
    # stratified samples; keep for parity, False normalizes by the samples taken.
    kajo_spp_quirk: bool = True
    # cull lanes whose path throughput drops below this and regenerate (the
    # reference GL backend's biased occupancy trick at 0.01); 0 is exact.
    regen_threshold: float = 0.0
    # sample ONE uniformly chosen light per vertex, scaled by L, instead of
    # every light: unbiased, one shadow ray per vertex, more variance.
    one_light_nee: bool = False
    # the GL backend's exact estimator: emission on the first vertex only, no
    # roulette, the throughput cull, no background on a miss; honoured by
    # the wavefront and the parity engine, refused by the megakernel.
    gl_semantics: bool = False


def _maxrgb(c):
    return torch.amax(c[..., :3], -1)


def _gather_materials(mats: Materials, obj) -> Materials:
    safe = torch.clamp_min(obj, 0)
    return Materials(**{f.name: getattr(mats, f.name)[safe] for f in dataclasses.fields(Materials)})


def _light_pdf_for_hit(prep: PreparedScene, hit_obj, prev_obj, prev_pos):
    """Σ over lights of (hit that light, not self) · 1/Ω(light, prev_pos): the
    reference's per-light shadow traces along the BSDF direction, reduced to
    a lookup on the object the continuation ray hit (the light pdf is
    direction-independent)."""
    if prep.light_obj.shape[0] == 0:
        return torch.zeros(hit_obj.shape, dtype=torch.float32, device=hit_obj.device)
    is_light = hit_obj[:, None] == prep.light_obj[None, :]
    not_self = prev_obj[:, None] != prep.light_obj[None, :]
    pdf = lights.pdf(prep.light_center[None, :, :], prep.light_radius[None, :], prev_pos[:, None, :])
    return torch.sum(torch.where(is_light & not_self, pdf, 0.0), 1)


def _nee(prep: PreparedScene, hit, mat, u_light, m_lambert, m_phong, eps):
    """NEE over every emissive sphere -> [N, 4] radiance per throughput;
    ``u_light`` is [3, N, L]."""
    num_l = prep.light_obj.shape[0]
    if num_l == 0:
        return torch.zeros(hit.position.shape[:-1] + (4,), dtype=torch.float32, device=hit.position.device)

    n = hit.position.shape[0]
    pos = hit.position[:, None, :]
    center = prep.light_center[None, :, :]
    radius = prep.light_radius[None, :]
    dir_l, pdf_l = lights.sample(u_light[0], u_light[1], u_light[2], center, radius, pos)  # [N, L, 3], [N, L]

    # visibility: one shadow trace for every (lane, light) pair
    origins = (pos + dir_l * eps).reshape(n * num_l, 3)
    sh = trace(prep, origins, dir_l.reshape(n * num_l, 3))
    visible = sh.obj.reshape(n, num_l) == prep.light_obj[None, :]
    not_self = hit.obj[:, None] != prep.light_obj[None, :]

    normal = hit.normal[:, None, :]
    view = hit.view[:, None, :]
    exp = mat.specular_exponent[:, None]
    pdf_b = torch.where(
        m_lambert[:, None],
        bsdf.lambert_pdf(normal, dir_l),
        torch.where(m_phong[:, None], bsdf.phong_pdf(view, normal, dir_l, exp), 0.0),
    )
    fcos = torch.where(
        m_lambert[:, None, None],
        bsdf.lambert_eval_cos(mat.diffuse[:, None, :], normal, dir_l),
        torch.where(
            m_phong[:, None, None],
            bsdf.phong_eval_cos(mat.specular[:, None, :], view, normal, dir_l, exp),
            0.0,
        ),
    )  # [N, L, 4]

    ok = visible & not_self & (pdf_b != 0) & (pdf_l > 0)
    weight = torch.where(ok, 1.0 / (pdf_b + pdf_l), 0.0)
    return torch.sum(weight[..., None] * fcos * prep.light_emission[None, :, :], 1)


def _nee_one_light(prep: PreparedScene, hit, mat, u_sel, u3, m_lambert, m_phong, eps):
    """One-of-L NEE: a uniformly chosen light per lane, its term (with its own
    MIS weight) scaled by L; one shadow trace per vertex -> [N, 4]."""
    num_l = prep.light_obj.shape[0]
    li = torch.clamp_max((u_sel * num_l).to(torch.int64), num_l - 1)
    center = prep.light_center[li]
    radius = prep.light_radius[li]
    lobj = prep.light_obj[li]
    emission = prep.light_emission[li]

    pos = hit.position
    dir_l, pdf_l = lights.sample(u3[0], u3[1], u3[2], center, radius, pos)
    sh = trace(prep, pos + dir_l * eps, dir_l)
    visible = sh.obj == lobj
    not_self = hit.obj != lobj

    exp = mat.specular_exponent
    pdf_b = torch.where(
        m_lambert,
        bsdf.lambert_pdf(hit.normal, dir_l),
        torch.where(m_phong, bsdf.phong_pdf(hit.view, hit.normal, dir_l, exp), 0.0),
    )
    fcos = torch.where(
        m_lambert[:, None],
        bsdf.lambert_eval_cos(mat.diffuse, hit.normal, dir_l),
        torch.where(m_phong[:, None], bsdf.phong_eval_cos(mat.specular, hit.view, hit.normal, dir_l, exp), 0.0),
    )
    ok = visible & not_self & (pdf_b != 0) & (pdf_l > 0)
    weight = torch.where(ok, num_l / (pdf_b + pdf_l), 0.0)
    return weight[:, None] * fcos * emission


def render_samples(prep: PreparedScene, o: torch.Tensor, d: torch.Tensor, key, config: RenderConfig,
                   columns=None) -> torch.Tensor:
    """Path-trace one radiance sample per input ray -> [N, 4]. ``key`` is a
    u32 seed or a key; bounce ``depth`` draws ``key.fold_in(depth)``.
    ``columns`` = (lo, total): the rays are lanes lo .. lo + N - 1 of
    ``total`` (a rank's block of a sharded pass), and draw those columns of
    a draw over all ``total``."""
    key = as_key(key)
    n = o.shape[0]
    dev = o.device
    num_lights = prep.light_obj.shape[0]
    eps = config.surface_epsilon

    def f4(v):
        return torch.full((n, 4), v, dtype=torch.float32, device=dev)

    if prep.materials.diffuse.shape[0] == 0:  # empty scene: background only
        return prep.background.expand(n, 4).clone()

    o_cur, d_cur = o, d
    t = f4(1.0)
    r = f4(0.0)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    emit = torch.ones(n, dtype=torch.bool, device=dev)
    mis_pending = torch.zeros(n, dtype=torch.bool, device=dev)
    pend_pdf_b = torch.ones(n, dtype=torch.float32, device=dev)
    pend_fcos = f4(1.0)
    pend_delta = torch.zeros(n, dtype=torch.bool, device=dev)
    prev_obj = torch.full((n,), -1, dtype=torch.int64, device=dev)
    prev_pos = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    gl = bool(config.gl_semantics)
    emit_after_scatter = (not config.direct_lighting) or config.full_mis
    nu = 3 + 3 * num_lights + 2

    for depth in range(config.max_depth + 1):
        if depth and not bool(alive.any()):
            break  # every path has ended: no later bounce adds anything
        if columns is None:
            u = key.fold_in(depth).uniform((nu, n), dev)
        else:
            u = uniform_columns(key.fold_in(depth), (nu, columns[1]), columns[0], columns[0] + n, dev)

        hit = trace(prep, o_cur, d_cur)
        was_hit = hit.obj >= 0

        # --- the deferred MIS weight of the previous bounce; GL mode: no
        # not-self test, and delta continuations carry no light pdf
        pdf_l_vis = _light_pdf_for_hit(prep, hit.obj, torch.full_like(prev_obj, -1) if gl else prev_obj, prev_pos)
        if config.full_mis or gl:
            # a delta BSDF cannot be sampled by NEE: its continuation keeps
            # full weight (the pdf_l + 1 denominator is parity mode's quirk)
            pdf_l_vis = torch.where(pend_delta, 0.0, pdf_l_vis)
        denom = pdf_l_vis + pend_pdf_b
        weight = pend_fcos / torch.where(denom == 0, 1.0, denom)[:, None]
        t = torch.where((mis_pending & alive)[:, None], t * weight, t)

        if gl:
            # GL's post-shade throughput cull: path termination here, after
            # the deferred weight, before this vertex's contributions
            gl_cull = config.regen_threshold if config.regen_threshold > 0.0 else 0.01
            alive = alive & ~(torch.amax(t[..., :3], -1) < gl_cull)

        # --- miss: the lane dies; background only in the CPU scheme
        miss = alive & ~was_hit
        if not gl:
            r = r + torch.where(miss[:, None], t * prep.background[None, :], 0.0)
        alive = alive & was_hit

        mat = _gather_materials(prep.materials, hit.obj)

        # --- Russian roulette (GL mode: none) ---------------------------
        if gl:
            cont = torch.ones_like(alive)
        else:
            p_rr = _maxrgb(torch.maximum(torch.maximum(mat.diffuse, mat.specular), mat.transparency))
            cont, prob_rr = sampling.flip_coin(u[0], p_rr.detach())
            t = torch.where(alive[:, None], t / prob_rr[:, None], t)
        # the local emission carries all of this vertex's stochastic factors,
        # so it is added below; a lane killed here carries the RR factor only
        t_kill = t
        emitter = alive & (torch.full_like(alive, depth == 0) if gl else emit)
        alive = alive & cont & (depth < config.max_depth)

        # --- BSDF lottery -------------------------------------------------
        sum_d = torch.sum(mat.diffuse[:, :3], -1)
        sum_s = torch.sum(mat.specular[:, :3], -1)
        sum_t = torch.sum(mat.transparency[:, :3], -1)
        total = sum_d + sum_s + sum_t
        p_t = torch.where(total > 0, sum_t / torch.where(total == 0, 1.0, total), 0.0)
        transmit, prob_t = sampling.flip_coin(u[1], p_t.detach())
        t = torch.where(alive[:, None], t / prob_t[:, None], t)

        ds = sum_d + sum_s
        p_d = torch.where(ds > 0, sum_d / torch.where(ds == 0, 1.0, ds), 0.0)
        diff, prob_d = sampling.flip_coin(u[2], p_d.detach())
        t = torch.where((alive & ~transmit)[:, None], t / prob_d[:, None], t)

        m_transmit = alive & transmit
        m_lambert = alive & ~transmit & diff
        m_phong = alive & ~transmit & ~diff & (mat.specular_exponent > 0)
        m_mirror = alive & ~transmit & ~diff & (mat.specular_exponent <= 0)

        # --- NEE (Lambert/Phong only; delta BSDFs gated by pdf == 0) ------
        if config.direct_lighting and num_lights:
            if config.one_light_nee and num_lights > 1:
                nee = _nee_one_light(prep, hit, mat, u[3], (u[4], u[5], u[6]), m_lambert, m_phong, eps)
            else:
                u_l = u[3 : 3 + 3 * num_lights].reshape(3, num_lights, n).permute(0, 2, 1)
                nee = _nee(prep, hit, mat, u_l, m_lambert, m_phong, eps)
            r = r + torch.where((m_lambert | m_phong | m_mirror)[:, None], t * nee, 0.0)

        # --- continuation ray ---------------------------------------------
        u1, u2 = u[nu - 2], u[nu - 1]
        d_trans, _ = bsdf.transmission_sample(hit.view, hit.normal, mat.refractive_index)
        d_lam, pdf_lam = bsdf.lambert_sample(u1, u2, hit.tangent, hit.binormal, hit.normal)
        d_ph, pdf_ph = bsdf.phong_sample(u1, u2, hit.view, hit.normal, mat.specular_exponent)
        d_mir, _ = bsdf.reflector_sample(hit.view, hit.normal)

        new_d = torch.where(
            m_transmit[:, None],
            d_trans,
            torch.where(m_lambert[:, None], d_lam, torch.where(m_phong[:, None], d_ph, d_mir)),
        )
        pdf_b = torch.where(m_lambert, pdf_lam, torch.where(m_phong, pdf_ph, torch.ones_like(pdf_lam)))
        fcos = torch.where(
            m_transmit[:, None],
            bsdf.transmission_eval_abscos(mat.specular, hit.normal, d_trans),
            torch.where(
                m_lambert[:, None],
                bsdf.lambert_eval_cos(mat.diffuse, hit.normal, d_lam),
                torch.where(
                    m_phong[:, None],
                    bsdf.phong_eval_cos(mat.specular, hit.view, hit.normal, d_ph, mat.specular_exponent),
                    bsdf.reflector_eval_cos(mat.specular, hit.normal, d_mir),
                ),
            ),
        )

        # transmission multiplies the throughput at once (no MIS deferral)
        t = torch.where(m_transmit[:, None], t * fcos, t)
        # the vertex's emission with its exact per-branch weight
        r = r + torch.where(emitter[:, None], torch.where(alive[:, None], t, t_kill) * mat.emission, 0.0)
        # a zero-pdf BSDF sample kills the lane
        alive = alive & (m_transmit | (pdf_b != 0))

        scatter = m_lambert | m_phong | m_mirror
        o_cur = torch.where(alive[:, None], hit.position + new_d * eps, o_cur)
        d_cur = torch.where(alive[:, None], new_d, d_cur)
        emit = torch.where(scatter, emit_after_scatter, emit)
        mis_pending = scatter
        pend_pdf_b = torch.where(scatter, pdf_b, 1.0)
        pend_fcos = torch.where(scatter[:, None], fcos, 1.0)
        pend_delta = m_mirror
        prev_obj = torch.where(scatter, hit.obj, -1)
        prev_pos = torch.where(scatter[:, None], hit.position, 0.0)
    return r


def _stratified_coords(width, height, grid, u_jitter, device):
    """Per-stratum screen coordinates: the grid cell plus jitter, with the
    reference's (H - y) flip."""
    x = torch.arange(width, dtype=torch.float32, device=device)
    y = torch.arange(height, dtype=torch.float32, device=device)
    xs, ys = torch.meshgrid(x, y, indexing="xy")  # [H, W]
    gx, gy = u_jitter  # [G2, H, W] stratum fractions with the jitter folded in
    sx = (xs[None] + gx) / width
    sy = ((height - ys)[None] + gy) / height
    return sx.reshape(-1), sy.reshape(-1)


def render_pass(scene: Scene, key, width: int, height: int, spp: int, config: RenderConfig = RenderConfig()):
    """One progressive pass -> [H, W, 4] linear radiance: floor(sqrt(spp))²
    jittered strata, one wavefront of W·H lanes each, summed and divided by
    ``spp`` (the kajo quirk) or by the strata taken. ``key`` is the u32 pass
    seed or a key; stratum i draws ``key.fold_in(i)``."""
    key = as_key(key)
    prep = prepare_scene(scene)
    dev = scene.device
    grid = max(int(spp**0.5), 1)
    eff = grid * grid
    divisor = float(spp if config.kajo_spp_quirk else eff)
    total = torch.zeros((width * height, 4), dtype=torch.float32, device=dev)
    for idx in range(eff):
        k = key.fold_in(idx)
        uj = k.uniform((2, height, width), dev)
        offs_x = (float(idx % grid) + uj[0]) / grid
        offs_y = (float(idx // grid) + uj[1]) / grid
        sx, sy = _stratified_coords(width, height, grid, (offs_x[None], offs_y[None]), dev)
        o, d = generate_rays(prep.camera, sx, sy)
        total = total + render_samples(prep, o, d, k.fold_in(7919), config)
    return (total / divisor).reshape(height, width, 4)


def render_image(scene: Scene, width: int, height: int, spp: int, key, passes: int = 1,
                 config: RenderConfig = RenderConfig()):
    """Multi-pass progressive render: the mean of ``passes`` passes, pass p
    with ``key.fold_in(p)``."""
    key = as_key(key)
    total = torch.zeros((height, width, 4), dtype=torch.float32, device=scene.device)
    for p in range(passes):
        total = total + render_pass(scene, key.fold_in(p), width, height, spp, config)
    return total / passes
