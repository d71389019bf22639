"""Port megakernel (plain PyTorch version) against the C++ reference's golden
image of data/caustics.json at 32x24, 16 spp, 10 passes, with the tolerances
of the JAX package's caustics golden test (test_integrator.py)."""

import os

import numpy as np
from torch_port import DATA, GOLDENS, mean_rel, tm_mad

from kajo_tpu_torch.ops.megakernel import render_passes_megakernel
from kajo_tpu_torch.scene import parser


def test_caustics_golden():
    scene = parser.load(os.path.join(DATA, "caustics.json"), 32 / 24, device="cpu")
    img = render_passes_megakernel(scene, 17, 0, 32, 24, 16, 10).numpy() / 10
    ref = np.fromfile(os.path.join(GOLDENS, "caustics_32x24.raw"), np.float32).reshape(24, 32, 4)
    assert np.isfinite(img).all()
    assert tm_mad(img, ref) < 0.1
    assert mean_rel(img, ref) < 0.25
