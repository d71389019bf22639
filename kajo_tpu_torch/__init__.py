"""PyTorch + CUDA port of the kajo path tracer.

Mirrors the layout of the JAX package ``kajo_tpu`` (``scene/``, ``ops/``,
``models/``, ``utils/``, ``cli.py``), which stays the reference the port is
tested against. This package imports ``torch`` and never ``jax``, and
nothing of ``kajo_tpu``: ``utils/`` holds its own copies of the numpy-only
helpers it needs.

The CLI, ``python -m kajo_tpu_torch.cli``, renders on a CUDA device unless
told ``--device cpu``; so do the library entry points, unless given
``device="cpu"``. Scenes of up to 512 objects run one hand-written CUDA
kernel per pass (``csrc/megakernel.cu``, K1); larger ones the wavefront of
``models/wavefront.py``, which traces scenes above 1024 spheres through the
streaming kernels of ``csrc/stream_trace.cu`` (K5 nearest hit, K6 shadow
occlusion). On the CPU each kernel's plain PyTorch version runs instead.
"""
