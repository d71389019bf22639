"""Edge-aware visibility gradients: boundary sampling of sphere silhouettes.
Port of ``kajo_tpu/diff/edges.py``.

A sphere's visibility is a step function of the scene parameters, so the
interior gradients of the fused kernels (K3, K4) see nothing of a silhouette
that moves. This module adds the boundary term of Reynolds' transport
theorem for the primary (camera-ray) discontinuities, which spheres make
analytic:

    dI_p/dθ = interior + ∮_{edges ∩ p} (L_in − L_out) (v · n̂) dl

The silhouette of a sphere (centre c, radius r) seen from o is a circle,
p(φ) = c − (r²/D) â + r√(1−r²/D²)(cos φ e₁ + sin φ e₂), D = |c − o|, a
smooth function of (c, r). The screen-space line integral is sampled at M
stratified angles: p(φ) is projected to pixels x(φ; c, r) (differentiable),
the radiance on both sides of the edge is estimated by parity-engine probes
±δ pixels along the screen normal (an occluded edge sees L_in ≈ L_out and
adds nothing), and

    g(c, r) = Σ_s  [cot·(L_in − L_out)]_s · |dx/dφ|_s · (2π/M) · (n̂_s · x_s)

is differentiated with everything but x_s detached: its gradient is the
boundary term. :func:`shadow_silhouette_grads` does the same for the
NEE-visibility (shadow) edges at primary vertices, where an occluder's
silhouette seen from the shading point is a circle in direction space.

Draws go through a key (``ops/rng.py``), as in the JAX module: the same key
gives the JAX package's uniforms in the tests. Everything runs on the
scene's device.
"""

from __future__ import annotations

import math

import torch

from ..models.integrator import RenderConfig, render_samples
from ..ops import bsdf, lights
from ..ops.geometry import generate_rays, prepare_scene, trace
from ..ops.rng import as_key
from ..scene.types import Scene, map_tensors
from ..utils.math3d import project

# screen-space offset (in pixels) of the two one-sided radiance probes
EDGE_DELTA_PX = 0.05
TWO_PI = 2.0 * math.pi


def _edge_points(centers, radii, phi, o_cam):
    """Silhouette circle points [S, M, 3] as a smooth function of (c, r);
    ``phi`` is [S, M]. The camera-origin case of :func:`_edge_points_from`."""
    return _edge_points_from(o_cam[None, :].expand(centers.shape), centers, radii, phi)


def _screen_pix(p, view, proj, width, height):
    """World points -> differentiable pixel coordinates (x right, y down)."""
    sp, w = project(p, view, proj)
    x = sp[..., 0] * width
    y = height - sp[..., 1] * height  # image rows grow downward
    return torch.stack([x, y], -1), w


def _detached(scene: Scene) -> Scene:
    return map_tensors(lambda t: t.detach(), scene)


def silhouette_loss_grads(
    scene: Scene,
    key,
    cotangent: torch.Tensor,
    width: int,
    height: int,
    config: RenderConfig = RenderConfig(),
    n_edge: int = 256,
):
    """Boundary-term gradients of sum(cotangent · image) with respect to the
    sphere centres [S, 3] and radii [S] (primary visibility edges only).
    ``key`` is a u32 seed or a key."""
    key = as_key(key)
    scene = _detached(scene)
    dev = scene.device
    view, proj = scene.camera.transform, scene.camera.projection
    prep = prepare_scene(scene)
    o_cam = prep.camera.origin
    centers = scene.sphere_transform[:, :3, 3].to(torch.float32).clone().requires_grad_(True)
    radii = scene.sphere_radius.to(torch.float32).clone().requires_grad_(True)
    s = centers.shape[0]
    cot = cotangent.detach().to(torch.float32)[..., :3]

    k_phi, k_trace = key.split(2)
    u0 = k_phi.uniform((s, 1), dev)
    phi_base = (torch.arange(n_edge, dtype=torch.float32, device=dev) / n_edge) * 2.0 * math.pi
    # stratified ring angles with a random per-sphere rotation
    phi = phi_base[None, :] + u0 * (TWO_PI / n_edge)  # [S, M]

    with torch.enable_grad():
        p = _edge_points(centers, radii, phi, o_cam)  # [S, M, 3]
        x, w_clip = _screen_pix(p, view, proj, width, height)  # [S, M, 2]

    # ---- the detached geometry of the edge ------------------------------
    xd = x.detach()
    cd, rd = centers.detach(), radii.detach()

    def x_of_phi(ph):
        return _screen_pix(_edge_points(cd, rd, ph, o_cam), view, proj, width, height)[0]

    _, tau = torch.func.jvp(x_of_phi, (phi,), (torch.ones_like(phi),))  # [S, M, 2] screen tangent dx/dφ
    tau_len = torch.linalg.norm(tau, dim=-1)
    # screen normal: the tangent turned 90°, away from the projected centre
    n_raw = torch.stack([tau[..., 1], -tau[..., 0]], -1)
    n_raw = n_raw / torch.clamp_min(tau_len[..., None], 1e-12)
    xc, _ = _screen_pix(cd[:, None, :], view, proj, width, height)
    outward = torch.sum((xd - xc) * n_raw, -1)
    n_hat = n_raw * torch.sign(outward)[..., None]

    # ---- one-sided radiance probes (detached) ---------------------------
    def probe(offset_sign):
        xs = xd + offset_sign * EDGE_DELTA_PX * n_hat
        sx = (xs[..., 0] / width).reshape(-1)
        sy = ((height - xs[..., 1]) / height).reshape(-1)
        o, d = generate_rays(prep.camera, sx, sy)
        rad = render_samples(prep, o, d, k_trace, config)
        return rad[..., :3].reshape(s, n_edge, 3)

    l_in = probe(-1.0)
    l_out = probe(1.0)

    # the cotangent at the edge pixel: column x covers x_pix in [x, x+1)
    # (floor), row y covers y_pix in (y-1, y] (ceil; the jitter is subtracted
    # in the (H - py) flip); a row off by one flips the y-gradient's sign
    # where the cotangent changes sign across the rim
    ix = torch.clamp(torch.floor(xd[..., 0]).to(torch.int64), 0, width - 1)
    iy = torch.clamp(torch.ceil(xd[..., 1]).to(torch.int64), 0, height - 1)
    cot_e = cot[iy, ix]  # [S, M, 3]

    in_image = (xd[..., 0] >= 0.0) & (xd[..., 0] < width) & (xd[..., 1] >= 0.0) & (xd[..., 1] < height)
    dist = torch.linalg.norm(cd - o_cam[None, :], dim=-1)
    visible_sphere = (dist > rd)[:, None]
    front = w_clip.detach() > 0.0
    valid = in_image & visible_sphere & front & (tau_len > 1e-9)

    w_s = torch.where(valid, torch.sum(cot_e * (l_in - l_out), -1) * tau_len * (TWO_PI / n_edge), 0.0)
    with torch.enable_grad():
        # only x is differentiated; w_s and n_hat are detached
        g = torch.sum(w_s * torch.sum(n_hat * x, -1))
        gc, gr = torch.autograd.grad(g, (centers, radii))
    return gc, gr


def _edge_points_from(origins, centers, radii, phi):
    """Silhouette circle of (centers, radii) seen from per-row ``origins``
    [N, 3] -> [N, M, 3]; smooth in (centers, radii). A sphere's silhouette
    from any point is a circle."""
    a_vec = centers - origins
    d2 = torch.sum(a_vec * a_vec, -1, keepdim=True)
    dist = torch.sqrt(torch.clamp_min(d2, 1e-20))
    a = a_vec / dist
    up = torch.where(
        (a[:, 1].abs() < 0.9)[:, None], a.new_tensor([0.0, 1.0, 0.0]), a.new_tensor([1.0, 0.0, 0.0])
    )
    e1 = torch.linalg.cross(a, up)
    e1 = e1 / torch.linalg.norm(e1, dim=-1, keepdim=True)
    e2 = torch.linalg.cross(a, e1)
    sin_t = radii[:, None] / dist
    # a floor, not 0: sqrt(0)'s infinite derivative would poison the whole
    # gradient (0·inf) where the viewpoint lies on a sphere (dist == r);
    # those rows are masked to zero weight
    cos_t2 = torch.clamp_min(1.0 - sin_t * sin_t, 1e-12)
    ring_c = centers - (radii[:, None] * sin_t) * a
    ring_r = radii[:, None] * torch.sqrt(cos_t2)
    cphi = torch.cos(phi)[..., None]
    sphi = torch.sin(phi)[..., None]
    return ring_c[:, None, :] + ring_r[:, None, :] * (cphi * e1[:, None, :] + sphi * e2[:, None, :])


def shadow_silhouette_grads(
    scene: Scene,
    key,
    cotangent: torch.Tensor,
    width: int,
    height: int,
    config: RenderConfig = RenderConfig(),
    n_edge: int = 4,
):
    """NEE-visibility (shadow) boundary gradients at primary vertices.

    For each primary hit p, occluder sphere j and light l, the occluded set
    of light directions is bounded by j's silhouette circle seen from p.
    Reynolds over the light's solid angle gives, per edge sample ω(φ):

        d(NEE)/dθ += (V_in − V_out) · K(ω) · (n̂_ω · dω/dθ) · sinα · (2π/M) / Ω_l

    with K the smooth NEE integrand (per-branch MIS weight · f·cos · L_e;
    the lotteries' 1/p factors cancel in expectation, so the Lambert and
    Phong terms are summed), V probed by two rays ±δ across the edge (which
    gates the light's cone and other occluders: both sides blocked → ΔV = 0),
    and everything but ω detached. Shadow edges at deeper vertices are not
    sampled."""
    key = as_key(key)
    scene = _detached(scene)
    dev = scene.device
    prep = prepare_scene(scene)
    num_l = int(prep.light_obj.shape[0])
    s = int(scene.num_spheres)
    if num_l == 0 or s == 0:
        return torch.zeros((s, 3), dtype=torch.float32, device=dev), torch.zeros((s,), dtype=torch.float32, device=dev)
    num_p = int(prep.plane_nrow.shape[0])
    centers = scene.sphere_transform[:, :3, 3].to(torch.float32).clone().requires_grad_(True)
    radii = scene.sphere_radius.to(torch.float32).clone().requires_grad_(True)
    eps = config.surface_epsilon
    delta_ang = 2e-3
    m = n_edge

    # one jittered primary ray per pixel (the wavefront's camera-ray
    # convention: row py's footprint is sy·H in [H − py, H − py + 1))
    k_pix, k_phi = key.split(2)
    n = width * height
    u = k_pix.uniform((2, n), dev)
    lane = torch.arange(n, dtype=torch.float32, device=dev)
    px = lane % width
    py = torch.floor(lane / width)
    o_cam, d_cam = generate_rays(prep.camera, (px + u[0]) / width, (height - py + u[1]) / height)
    hit = trace(prep, o_cam, d_cam)
    hit_obj = hit.obj
    safe = torch.clamp_min(hit_obj, 0)
    mats = prep.materials

    # (pixel, occluder) pairs flattened: row i·S + j is (pixel i, sphere j)
    p_r = torch.repeat_interleave(hit.position, s, 0)  # [N·S, 3]
    n_r = torch.repeat_interleave(hit.normal, s, 0)
    v_r = torch.repeat_interleave(hit.view, s, 0)
    hobj_r = torch.repeat_interleave(hit_obj, s)
    exp_r = torch.repeat_interleave(mats.specular_exponent[safe], s, 0)
    diff_r = torch.repeat_interleave(mats.diffuse[safe], s, 0)
    spec_r = torch.repeat_interleave(mats.specular[safe], s, 0)
    cot_r = torch.repeat_interleave(cotangent.detach().to(torch.float32)[..., :3].reshape(n, 3), s, 0)
    light_obj = prep.light_obj
    # [N, L]: direction-independent
    pdf_l = lights.pdf(prep.light_center[None, :, :], prep.light_radius[None, :], hit.position[:, None, :])
    pl = torch.repeat_interleave(pdf_l, s, 0)[:, None, :]  # [N·S, 1, L]

    phi0 = k_phi.uniform((n * s, 1), dev) * (TWO_PI / m)
    phi = phi0 + (torch.arange(m, dtype=torch.float32, device=dev) * (TWO_PI / m))[None, :]

    with torch.enable_grad():
        c_r = centers.repeat(n, 1)  # [N·S, 3]
        r_r = radii.repeat(n)
        x = _edge_points_from(p_r, c_r, r_r, phi)  # [N·S, M, 3]
        w_dir = x - p_r[:, None, :]
        w_len = torch.sqrt(torch.clamp_min(torch.sum(w_dir * w_dir, -1), 1e-20))
        omega = w_dir / w_len[..., None]  # the only differentiated quantity
    om_d = omega.detach()

    c_d = centers.detach().repeat(n, 1)
    r_d = radii.detach().repeat(n)
    dist = torch.sqrt(torch.clamp_min(torch.sum((c_d - p_r) ** 2, -1), 1e-20))
    axis = (c_d - p_r) / dist[:, None]
    sin_a = torch.clamp(r_d / dist, 0.0, 1.0)  # angular radius of the cone

    # outward normal of the occlusion cone in direction space: the
    # rejection of −axis onto the tangent plane at ω
    n_e = om_d * torch.sum(om_d * axis[:, None, :], -1, keepdim=True) - axis[:, None, :]
    n_e = n_e / torch.clamp_min(torch.linalg.norm(n_e, dim=-1, keepdim=True), 1e-12)

    # ±δ visibility probes (in = inside the occlusion cone), one trace
    dirs = torch.stack([om_d - delta_ang * n_e, om_d + delta_ang * n_e])
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    org = p_r[None, :, None, :].expand(dirs.shape)
    sh = trace(prep, (org + dirs * eps).reshape(-1, 3), dirs.reshape(-1, 3))
    obj_pr = sh.obj.reshape(2, n * s, m)
    # [N·S, M, L] = V_in − V_out
    dv = (obj_pr[0][..., None] == light_obj).to(torch.float32) - (obj_pr[1][..., None] == light_obj).to(torch.float32)

    # K(ω) per light: pdf_l·f·cos·L_e/(pdf_b + pdf_l), through the BSDF
    # functions of the integrator's NEE, so the integrand matches it
    nb, vb = n_r[:, None, :], v_r[:, None, :]
    f_lam = bsdf.lambert_eval_cos(diff_r[:, None, :], nb, om_d)[..., :3]
    pdf_lam = bsdf.lambert_pdf(nb, om_d)  # [N·S, M]
    expb = exp_r[:, None].expand(pdf_lam.shape)
    f_ph = bsdf.phong_eval_cos(spec_r[:, None, :], vb, nb, om_d, expb)[..., :3]
    pdf_ph = bsdf.phong_pdf(vb, nb, om_d, expb)

    def branch(f, pdf_b, gate):
        den = pdf_b[..., None] + pl  # [N·S, M, L]
        ok = gate[..., None] & (pl > 0)
        return torch.where(ok[..., None], f[:, :, None, :] / torch.where(den == 0, 1.0, den)[..., None], 0.0)

    k_int = branch(f_lam, pdf_lam, pdf_lam != 0) + branch(f_ph, pdf_ph, (expb > 0) & (pdf_ph != 0))
    k_int = k_int * prep.light_emission[None, None, :, :3] * pl[..., None]  # [N·S, M, L, 3]

    sphere_obj = num_p + torch.arange(s, dtype=torch.int64, device=dev)
    occ_obj = sphere_obj.repeat(n)  # [N·S]
    valid = (hobj_r >= 0) & (hobj_r != occ_obj) & (dist > r_d)
    # the occluder is not the light, and the shading point is not on it
    lmask = (occ_obj[:, None] != light_obj[None, :]) & (hobj_r[:, None] != light_obj[None, :])
    coeff = torch.sum(
        torch.where(
            valid[:, None, None] & lmask[:, None, :],
            dv * torch.sum(cot_r[:, None, None, :] * k_int, -1),
            0.0,
        ),
        -1,
    )  # [N·S, M]
    w_s = coeff * sin_a[:, None] * (TWO_PI / m)
    with torch.enable_grad():
        g = torch.sum(w_s * torch.sum(n_e * omega, -1))
        gc, gr = torch.autograd.grad(g, (centers, radii))
    return gc, gr


class _SilhouetteTerm(torch.autograd.Function):
    """Zero image [H, W, 4]; its backward is the boundary gradient, routed
    into the sphere transforms' translation column and the radii."""

    @staticmethod
    def forward(ctx, sphere_transform, sphere_radius, scene, key, width, height, config, n_edge, shadow_edges,
                n_shadow_edge):
        ctx.args = (scene, key, width, height, config, n_edge, shadow_edges, n_shadow_edge)
        return sphere_transform.new_zeros((height, width, 4))

    @staticmethod
    def backward(ctx, cot):
        scene, key, width, height, config, n_edge, shadow_edges, n_shadow_edge = ctx.args
        gc, gr = silhouette_loss_grads(scene, key, cot, width, height, config, n_edge)
        if shadow_edges:
            gc2, gr2 = shadow_silhouette_grads(scene, key.fold_in(1), cot, width, height, config, n_shadow_edge)
            gc, gr = gc + gc2, gr + gr2
        st_bar = torch.zeros_like(scene.sphere_transform)
        st_bar[:, :3, 3] = gc
        return st_bar, gr, None, None, None, None, None, None, None, None


def make_silhouette_term(
    width: int,
    height: int,
    config: RenderConfig = RenderConfig(),
    n_edge: int = 256,
    shadow_edges: bool = False,
    n_shadow_edge: int = 4,
):
    """A zero-valued image term whose backward is the silhouette boundary
    gradient: ``img = render(scene) + term(scene, key)`` adds nothing to the
    image, and under autograd the image's cotangent flows into the boundary
    integral, completing the interior gradients at visibility
    discontinuities. ``shadow_edges=True`` adds the NEE-visibility term
    (``n_shadow_edge`` ring samples per pixel and occluder) under
    ``key.fold_in(1)``."""

    def term(scene: Scene, key) -> torch.Tensor:
        return _SilhouetteTerm.apply(scene.sphere_transform, scene.sphere_radius, scene, as_key(key), width, height,
                                     config, n_edge, shadow_edges, n_shadow_edge)

    return term
