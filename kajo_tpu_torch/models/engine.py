"""Engine selection, port of ``kajo_tpu/models/engine.py``.

The port has one engine so far, ``mega``: the fused pass of
``ops/megakernel.py``, on the scene's device (the CUDA kernel on a GPU, its
plain PyTorch twin on the CPU). The JAX package's other engines come with
later slices of the port (ROADMAP Queue 1), and asking for one raises.
"""

from __future__ import annotations

from ..ops import megakernel
from ..scene.types import Scene
from .integrator import RenderConfig

# engines of the JAX package that the port does not have yet, and the
# ROADMAP slice that brings each
_LATER = {
    "fast": "the big-scene slice (models/wavefront.py + the streaming trace)",
    "parity": "the integrator slice (models/integrator.py render_pass)",
}


def select_engine(scene: Scene, requested: str = "auto") -> str:
    if requested in ("auto", "mega"):
        if not megakernel.supports(scene):
            raise ValueError(
                f"the mega engine takes 1..{megakernel.MAX_KERNEL_OBJECTS} objects, this "
                f"scene has {scene.num_objects}; larger scenes need {_LATER['fast']}"
            )
        return "mega"
    if requested in _LATER:
        raise ValueError(f"engine {requested!r} is not ported yet: it comes with {_LATER[requested]}")
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
    """One pass of ``engine`` with u32 pass seed ``seed`` -> [H, W, 4]."""
    select_engine(scene, engine)  # raises for an engine the port lacks
    return megakernel.render_pass_megakernel(scene, seed, width, height, spp, config)
