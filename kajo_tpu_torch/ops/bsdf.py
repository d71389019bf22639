"""The four BSDFs as pure, batched functions (port of ``kajo_tpu/ops/bsdf.py``).

Each BSDF has:

  * ``*_sample(...) -> (direction, pdf)``, an importance-sampled direction;
  * ``*_eval_cos(...) -> f(dir) * max(0, n·dir)``, the BRDF already
    multiplied by the clamped cosine (safe for the delta BSDFs, whose raw
    ``f`` holds a 1/cos that cancels);
  * ``*_pdf(...)``, the density of ``*_sample`` in a given direction (the
    raw Lambert pdf goes negative below the horizon; callers gate on
    ``pdf != 0`` as the reference does).

``view`` is the incident ray direction (pointing into the surface), normals
are unit, colors carry a trailing RGB(A) axis. Everything broadcasts over
leading batch dimensions.
"""

from __future__ import annotations

import torch

from .sampling import INV_PI, PI, cosine_hemisphere, local_to_world, phong_lobe, safe_normalize, safe_pow, safe_sqrt


def _dot(a, b, keepdim=True):
    return torch.sum(a * b, -1, keepdim=keepdim)


def reflect(v, n):
    """GLM reflect: v - 2 dot(n, v) n."""
    return v - 2.0 * _dot(n, v) * n


def refract_or_reflect(view, normal, eta_ratio):
    """Ideal transmission direction; ``normal`` faces the incoming side;
    mirror reflection on total internal reflection. ``eta_ratio`` is
    n_incident / n_transmitted."""
    cos_i = _dot(view, normal)
    k = 1.0 - eta_ratio * eta_ratio * (1.0 - cos_i * cos_i)
    refracted = eta_ratio * view - (eta_ratio * cos_i + safe_sqrt(k)) * normal
    return torch.where(k < 0, reflect(view, normal), refracted)


# ---------------------------------------------------------------- Lambert
def lambert_sample(u1, u2, tangent, binormal, normal):
    d_local, pdf = cosine_hemisphere(u1, u2)
    return local_to_world(d_local, tangent, binormal, normal), pdf


def lambert_eval_cos(diffuse, normal, direction):
    return diffuse * INV_PI * torch.clamp_min(_dot(normal, direction), 0.0)


def lambert_pdf(normal, direction):
    """cosθ/π, unclamped like the reference."""
    return INV_PI * _dot(normal, direction, keepdim=False)


# ------------------------------------------------------------------ Phong
def _phong_frame(view, normal):
    """Frame about the reflection vector, built from ẑ; from ŷ where the
    reflection is parallel to ẑ."""
    r = reflect(view, normal)
    # the axes filled on the device: no copy from the host (a CUDA graph
    # captures the wavefront's body)
    axes = torch.eye(3, dtype=r.dtype, device=r.device)
    z = axes[2].expand(r.shape)
    u = torch.linalg.cross(z, r)
    degenerate = _dot(u, u) < 1e-12
    y = axes[1].expand(r.shape)
    u = safe_normalize(torch.where(degenerate, torch.linalg.cross(y, r), u))
    v = torch.linalg.cross(u, r)
    return r, u, v


def phong_sample(u1, u2, view, normal, exponent):
    r, u, v = _phong_frame(view, normal)
    d_local, pdf = phong_lobe(u1, u2, exponent)
    return u * d_local[..., 0:1] + v * d_local[..., 1:2] + r * d_local[..., 2:3], pdf


def phong_eval_cos(specular, view, normal, direction, exponent):
    r = reflect(view, normal)
    cos_a = torch.clamp_min(_dot(r, direction), 0.0)
    e = exponent[..., None]
    lobe = (e + 1.0) / (2.0 * PI) * safe_pow(cos_a, e)
    return specular * lobe * torch.clamp_min(_dot(normal, direction), 0.0)


def phong_pdf(view, normal, direction, exponent):
    r = reflect(view, normal)
    cos_a = torch.clamp_min(_dot(r, direction, keepdim=False), 0.0)
    return (exponent + 1.0) / (2.0 * PI) * safe_pow(cos_a, exponent)


# --------------------------------------------------------- Ideal reflector
def reflector_sample(view, normal):
    """Delta mirror: the direction, with discrete probability 1."""
    d = reflect(view, normal)
    return d, torch.ones(d.shape[:-1], dtype=d.dtype, device=d.device)


def reflector_eval_cos(specular, normal, direction):
    """f·cos = specular where n·dir > 0, else 0 (the raw f is spec/cosθ)."""
    return torch.where(_dot(normal, direction) > 0, specular, 0.0)


# ------------------------------------------------------ Ideal transmission
def transmission_sample(view, normal, refractive_index):
    """Delta refraction with entering/exiting eta and the TIR fallback ->
    (direction, probability 1)."""
    entering = _dot(view, normal) < 0
    n_eff = torch.where(entering, normal, -normal)
    ior = refractive_index[..., None]
    eta = torch.where(entering, 1.0 / ior, ior)
    d = refract_or_reflect(view, n_eff, eta)
    return d, torch.ones(view.shape[:-1], dtype=view.dtype, device=view.device)


def transmission_eval_abscos(color, normal, direction):
    """f·|cos| = color (the raw f is color/|cosθ|, an exact cancellation)."""
    return color.expand(direction.shape[:-1] + (color.shape[-1],))
