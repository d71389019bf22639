"""PyTorch + CUDA port of the kajo path tracer.

Mirrors the layout of the JAX package ``kajo_tpu`` (``scene/``, ``ops/``,
``models/``, ``cli.py``), which stays the reference the port is tested
against. This package imports ``torch`` and never ``jax``; it reuses the
JAX package's numpy-only helpers (``kajo_tpu.utils`` and
``kajo_tpu.runtime``), which import no jax either.

The main path, ``python -m kajo_tpu_torch.cli SCENE.json``, runs one
hand-written CUDA kernel per pass (``csrc/megakernel.cu``, wrapped by
``ops/megakernel.py``) on a CUDA device, and its plain PyTorch twin on the
CPU.
"""
