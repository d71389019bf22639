"""Engine selection, port of ``kajo_tpu/models/engine.py``.

  * ``mega``: the fused pass of ``ops/megakernel.py`` (K1), for scenes of
    1..512 objects;
  * ``fast``: the regenerating wavefront of ``models/wavefront.py``, for any
    scene; above ``geometry.STREAM_THRESHOLD`` spheres it traces through the
    streaming kernels K5/K6;
  * ``parity``: the fixed-depth scan of ``models/integrator.py``, the
    estimator as the reference's CPU backend computes it (the CLI's ``-r
    cpu``), for any scene; above ``geometry.STREAM_THRESHOLD`` spheres it
    traces through K5.

``auto`` follows the reference's rule on the port's device: ``mega`` for a
scene on the CUDA device that the megakernel takes (the reference: on the
TPU), else ``fast``, whose vectorised wavefront is the faster plain path on
the CPU. An explicit engine runs on the scene's device: the CUDA kernels on
a GPU, their plain PyTorch versions on the CPU; ``auto`` never picks
``parity``.
"""

from __future__ import annotations

from ..ops import megakernel
from ..scene.types import Scene
from .integrator import RenderConfig, render_pass
from .wavefront import render_pass_fast

ENGINES = ("auto", "mega", "fast", "parity")


def select_engine(scene: Scene, requested: str = "auto") -> str:
    if requested == "auto":
        return "mega" if scene.device.type == "cuda" and megakernel.supports(scene) else "fast"
    if requested == "mega":
        if not megakernel.supports(scene):
            raise ValueError(
                f"the mega engine takes 1..{megakernel.MAX_KERNEL_OBJECTS} objects, this scene has "
                f"{scene.num_objects}; use the fast engine"
            )
        return "mega"
    if requested in ("fast", "parity"):
        return requested
    raise ValueError(f"unknown engine {requested!r}")


def render_pass_engine(
    engine: str,
    scene: Scene,
    seed: int,
    width: int,
    height: int,
    spp: int,
    config: RenderConfig = RenderConfig(),
):
    """One pass of ``engine`` with u32 pass seed ``seed`` -> [H, W, 4]
    (engine ``parity`` also takes a key, see ``ops/rng.py``)."""
    engine = select_engine(scene, engine)
    if engine == "mega":
        return megakernel.render_pass_megakernel(scene, seed, width, height, spp, config)
    if engine == "fast":
        return render_pass_fast(scene, seed, width, height, spp, config)
    return render_pass(scene, seed, width, height, spp, config)
