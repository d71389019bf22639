"""The least time K5 (the streamed nearest hit) and K6 (the streamed
occlusion test) could take on a pass of a streamed field, by the rule of
``chip_smoke.py`` ``call_bound``.

Each call's operations are the (ray, 128-sphere block) pairs a
block-culled scan must test (a ray's blocks entered below its final
answer; for K6 an occluded ray only its first occluder's block), 128
sphere tests each, plus, on the rigid record, the ray-independent
cx²+cy²+cz²-r² once per sphere of a block some ray needs. Its bytes are
the boxes read once where a ray is live, the records of those blocks, and
each ray's inputs and outputs: a live ray's origin and direction (and
K6's excluded row), every ray's bound in and answer out.

The counts come from the reference's render of a fixed sample of the
image (``benchmark/jobs/progressive_field.py``): the per-ray terms are
scaled by the image's lanes over the sample's, the blocks some ray needs
are the sample's (at most the image's, so the bound errs low).
"""

from __future__ import annotations

from benchmark.bounds import OPS_SPHERE_GENERAL, OPS_SPHERE_RIGID, OPS_SPHERE_RIGID_ONCE, bound_ms

F_RIGID = 4  # floats of a rigid record
# bytes a live ray reads, bytes every ray reads and writes
RAY_BYTES = {"nearest": (24, 4 + 4 + 4), "occluded": (24 + 4, 4 + 4)}


def call_work(call: dict, scale: float) -> tuple:
    """(bytes, FP32 operations) of one call. ``call``: its counts on the
    sample (``kind``, ``pairs``, ``touched``, ``live``, ``rays``,
    ``fields``, ``blocks``); ``scale``: lanes of the image over the
    sample's."""
    per_live, per_ray = RAY_BYTES[call["kind"]]
    rigid = call["fields"] == F_RIGID
    n_bytes = (call["blocks"] * 8 * 4 if call["live"] else 0) + call["touched"] * 128 * call["fields"] * 4
    n_bytes += scale * (call["live"] * per_live + call["rays"] * per_ray)
    n_ops = scale * call["pairs"] * 128 * (OPS_SPHERE_RIGID if rigid else OPS_SPHERE_GENERAL)
    n_ops += call["touched"] * 128 * OPS_SPHERE_RIGID_ONCE if rigid else 0
    return n_bytes, n_ops


def pass_bound_ms(stream_pass: dict, kind: str, peak: dict) -> float | None:
    """The least ms a pass's calls of ``kind`` ("nearest": K5,
    "occluded": K6) could take: the sum of each call's bound."""
    calls = [c for c in stream_pass["calls"] if c["kind"] == kind]
    if not calls:
        return None
    total = sum(bound_ms(*call_work(c, stream_pass["scale"]), peak)[0] for c in calls)
    return total / stream_pass["passes"]
