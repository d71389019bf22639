"""The table of peaks and the least time a kernel could take (its roofline
bound): the larger of the bytes it must move over the card's memory
bandwidth and the FP32 operations it must do over its FP32 rate.

K1's operations are counted from the plain walk's counts of one pass
(:mod:`benchmark.reference.walk` ``stats``): its ray-object tests (one
per path or shadow ray and object; a rigid sphere's ray-independent part
cx²+cy²+cz²-r² once per sphere) and its shading, at one FP32 operation per
float operation of ``kajo_tpu_torch/csrc/megakernel.cu`` (transcendentals
one each, integer work and compares none): per sample its camera ray, per
path vertex its hit point and deferred MIS weight, per miss its background
term, per hit its roulette, lottery, reflection and emission term, per
vertex that continues its BSDF's sample, pdf and f cos, and per NEE light
sampled its light sample, solid angle, pdfs, weight and term. Its bytes
are the packed scene read once and three floats written a lane.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"

# FP32 operations of one ray-object test as K1 writes it
OPS_PLANE, OPS_SPHERE_RIGID, OPS_SPHERE_GENERAL = 14, 25, 63
OPS_SPHERE_RIGID_ONCE = 6
# FP32 operations of K1's shading: per camera ray, path vertex, miss, hit,
# continuation by each BSDF and NEE light sampled
OPS_CAMERA, OPS_VERTEX, OPS_MISS, OPS_HIT = 35, 8, 6, 46
OPS_LAMBERT, OPS_PHONG, OPS_MIRROR, OPS_TRANSMIT, OPS_NEE = 69, 96, 13, 36, 92


def peaks(device_name: str) -> dict | None:
    """The published peaks of the card named ``device_name`` (the first
    entry of the table whose key is in the name), or None."""
    for key, entry in json.loads(PEAKS_FILE.read_text()).items():
        if key in device_name:
            return entry
    return None


def bound_ms(n_bytes: float, n_ops: float, peak: dict) -> tuple:
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes = n_bytes / peak["hbm_bytes_per_s"]
    t_ops = n_ops / peak["fp32_flops_per_s"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def k1_work(shape: dict, stats: dict, passes: int) -> tuple:
    """(bytes, FP32 operations) of one K1 pass. ``shape``: n_lanes, eff,
    n_planes, n_spheres, rigid, packed_floats; ``stats``: the plain walk's
    counts over ``passes`` passes of that shape."""
    rigid = shape["rigid"]
    per_ray = shape["n_planes"] * OPS_PLANE + shape["n_spheres"] * (OPS_SPHERE_RIGID if rigid else OPS_SPHERE_GENERAL)
    once = shape["n_spheres"] * OPS_SPHERE_RIGID_ONCE if rigid else 0
    rays, hits = stats["rays"] / passes, stats["hits"] / passes
    tests = (rays + stats["shadow_rays"] / passes) * per_ray + once
    shading = (
        shape["n_lanes"] * shape["eff"] * OPS_CAMERA
        + rays * OPS_VERTEX
        + (rays - hits) * OPS_MISS
        + hits * OPS_HIT
        + (stats["lambert"] * OPS_LAMBERT + stats["phong"] * OPS_PHONG + stats["mirror"] * OPS_MIRROR
           + stats["transmit"] * OPS_TRANSMIT + stats["shadow_rays"] * OPS_NEE) / passes
    )
    n_bytes = shape["packed_floats"] * 4 + 12 * shape["n_lanes"]
    return n_bytes, tests + shading
