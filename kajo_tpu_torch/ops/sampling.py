"""Stochastic samplers with explicit pdfs (port of ``kajo_tpu/ops/sampling.py``).

Every sampler returns ``(value, pdf)``, the reference's ``RandomValue``
convention, which is the interface MIS needs. All functions are elementwise
over leading batch dimensions; ``u*`` arguments are uniforms in [0, 1).
Vectors are tensors with a trailing axis of 3.
"""

from __future__ import annotations

import numpy as np
import torch

PI = float(np.float32(np.pi))
INV_PI = float(np.float32(1.0 / np.pi))


def sqrt_f32(x):
    """The correctly rounded float32 square root, as the card's sqrtf and
    XLA give it. PyTorch's vectorised CPU sqrt is not always correctly
    rounded (an ulp off on ~0.5% of inputs); a float64 root rounded to
    float32 always is."""
    return torch.sqrt(x.double()).float()


def pow_f32(x, n):
    """float32 x**n through float64, rounded once: the libm powf result in
    all but rare cases. PyTorch's vectorised float32 pow is off by up to an
    ulp, and a Phong exponent of 150 multiplies that by 150."""
    return torch.pow(x.double(), n.double() if isinstance(n, torch.Tensor) else n).float()


def safe_sqrt(x):
    """sqrt, and 0 where x <= 0."""
    m = x > 0
    return torch.where(m, sqrt_f32(torch.where(m, x, 1.0)), 0.0)


def safe_pow(x, n):
    """x**n for x >= 0 with powf semantics (0**0 = 1): exponent 0 gives 1
    even at x = 0, where a plain pow of a masked base would give NaN."""
    m = x > 0
    return torch.where(m, pow_f32(torch.where(m, x, 1.0), n), torch.where(n == 0, 1.0, 0.0))


def safe_normalize(v):
    """Normalize along the last axis; 0 for a zero vector."""
    n2 = torch.sum(v * v, -1, keepdim=True)
    m = n2 > 0
    return torch.where(m, v * torch.rsqrt(torch.where(m, n2, 1.0)), 0.0)


def cosine_hemisphere(u1, u2):
    """Cosine-weighted hemisphere in local (t, b, n) coordinates; pdf = cosθ/π."""
    r = sqrt_f32(u1)
    phi = u2 * 2.0 * PI
    z = sqrt_f32(torch.clamp_min(1.0 - u1, 0.0))
    d = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)
    return d, z * INV_PI


def phong_lobe(u1, u2, exponent):
    """Phong lobe about local +z; pdf = (n+1)/(2π) cosⁿa. sin a is
    sqrt(1 - cos²a) (no acos)."""
    cos_a = safe_pow(u1, 1.0 / (exponent + 1.0))
    phi = 2.0 * PI * u2
    sin_a = safe_sqrt(1.0 - cos_a * cos_a)
    d = torch.stack([sin_a * torch.cos(phi), sin_a * torch.sin(phi), cos_a], -1)
    pdf = (exponent + 1.0) / (2.0 * PI) * safe_pow(cos_a, exponent)
    return d, pdf


def flip_coin(u, probability):
    """(took_branch, prob_of_drawn_branch): the branch is taken when
    ``p > 0 and u <= p``."""
    took = (probability > 0) & (u <= probability)
    return took, torch.where(took, probability, 1.0 - probability)


def local_to_world(d_local, tangent, binormal, normal):
    """Rotate a local (t, b, n) sample into the world frame."""
    return tangent * d_local[..., 0:1] + binormal * d_local[..., 1:2] + normal * d_local[..., 2:3]
