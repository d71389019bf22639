"""Estimator configuration, port of ``RenderConfig`` from
``kajo_tpu/models/integrator.py``.

The parity scan engine (``render_pass``, ``render_image``) is a later slice
of the port; this module holds only the configuration, with the JAX
package's fields, defaults and ``repr`` (the CLI's checkpoint metadata
compares that ``repr``).
"""

from __future__ import annotations

import dataclasses


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
    # the GL backend's exact estimator; implemented by the JAX package's
    # wavefront engines only, and refused by the megakernel.
    gl_semantics: bool = False
