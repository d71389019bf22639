"""Rays far outside a streamed test field, where the nearest-hit designs'
tile votes decide answers: made with numpy alone, for the JAX reference
script (``_jax_stream_designs_ref.py``) and the card's tests."""

import numpy as np


def far_rays(extent=20.0, seed=13, n=512):
    """n rays from 1e5-1e6 units out, nearly level, aimed at the field of
    ``random_spheres_scene(..., extent)`` (even rays) or 1-15 units above
    its spheres (odd rays) -> (o, d, t_max) f32 numpy arrays. So far out the
    quadratic's constant term |o|² - 2 o.c + |c|² - r² cancels to noise and
    reports hits on spheres a ray passes units away from; which of those a
    ray scans is the design's tile vote, not its own box test. Half the rays
    are bounded within those spurious hit distances, half are not."""
    rng = np.random.default_rng(seed)
    tgt = np.stack([rng.uniform(-extent, extent, n), rng.uniform(0.5, 0.95, n), rng.uniform(-extent, extent, n)], 1)
    tgt[1::2, 1] = 0.55 - rng.uniform(1.0, 15.0, n // 2)  # above the spheres (y points down)
    d = rng.normal(size=(n, 3))
    d[:, 1] = np.abs(d[:, 1]) * 0.05
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dist = 10.0 ** rng.uniform(5.0, 6.0, n)
    t_max = np.where(np.arange(n) % 4 < 2, np.inf, dist * rng.uniform(0.9, 1.1, n))
    return (tgt - dist[:, None] * d).astype(np.float32), d.astype(np.float32), t_max.astype(np.float32)
