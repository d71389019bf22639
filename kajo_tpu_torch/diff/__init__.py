"""Differentiable rendering and inverse rendering (port of ``kajo_tpu/diff``)."""
