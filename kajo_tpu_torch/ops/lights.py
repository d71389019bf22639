"""Spherical emitters: solid-angle sampling and pdfs (port of
``kajo_tpu/ops/lights.py``).

Lights are emissive spheres; emission is direction-independent and not
attenuated by distance (the solid-angle pdf accounts for the geometry). The
pdf is direction-independent too: 1/Ω, Ω the cone the sphere subtends, so
the MIS light pdf along a BSDF ray is a per-hit-object lookup.
"""

from __future__ import annotations

import torch

from .sampling import PI, safe_normalize, safe_sqrt


def solid_angle(center, radius, position):
    """Ω subtended by the sphere from ``position``; 4π inside it.

    The distance is sqrt(max(d², 1e-20)) and the cosine sqrt(max(1 - x²,
    1e-12)), so neither is 0/0 or infinite at a degenerate point, and
    1 - sqrt(1 - x²) is computed as x²/(1 + sqrt(1 - x²)): the naive form
    rounds to exactly 0 in f32 for x below ~2e-4 (a far, grazing light), and
    the pdf 1/Ω would be infinite."""
    d2 = torch.sum((center - position) ** 2, -1)
    dist = torch.sqrt(torch.clamp_min(d2, 1e-20))
    x = torch.clamp(radius / dist, 0.0, 1.0)
    c = torch.sqrt(torch.clamp_min(1.0 - x * x, 1e-12))
    omega = 2.0 * PI * (x * x) / (1.0 + c)
    return torch.where(dist < radius, 4.0 * PI, omega)


def sample(u1, u2, u3, center, radius, position):
    """Direction toward a point on the sphere, and pdf = 1/Ω.

    The reference's disk construction: (x, y) on a disk of the sphere's
    radius, z on the chord through it with a signed sine. Not exactly
    uniform in solid angle; the estimator divides by the solid-angle pdf all
    the same, as the reference does."""
    x = radius * torch.sqrt(u1) * torch.cos(2.0 * PI * u2)
    y = radius * torch.sqrt(u1) * torch.sin(2.0 * PI * u2)
    z = safe_sqrt(radius * radius - x * x - y * y) * torch.sin(PI * (u3 - 0.5))
    d = safe_normalize(center + torch.stack([x, y, z], -1) - position)
    return d, 1.0 / solid_angle(center, radius, position)


def pdf(center, radius, position):
    """Density assigned to any direction: 1/Ω."""
    return 1.0 / solid_angle(center, radius, position)
