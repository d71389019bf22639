"""PCG4D (Jarzynski & Olano, "Hash Functions for GPU Rendering", JCGT 2020)
on int64 tensors holding u32 values, and the progressive render's pass
seeds.

Each step masks to 32 bits; a product of two u32 values wraps in int64 and
keeps its low 32 bits right.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
INV24 = 1.0 / (1 << 24)
PASS_SALT = 0x50415353  # "PASS"


def pcg4d(a, b, c, d):
    """Four u32 counters (int64 tensors or ints, broadcastable) -> four u32
    words (int64 tensors, or ints when all four are ints)."""

    def lcg(v):
        if isinstance(v, torch.Tensor):
            v = v.to(torch.int64)
        return (v * 1664525 + 1013904223) & M32

    x, y, z, w = lcg(a), lcg(b), lcg(c), lcg(d)
    x = (x + y * w) & M32
    y = (y + z * x) & M32
    z = (z + x * y) & M32
    w = (w + y * z) & M32
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = (x + y * w) & M32
    y = (y + z * x) & M32
    z = (z + x * y) & M32
    w = (w + y * z) & M32
    return x, y, z, w


def uniforms4(lane, sample, salt, seed, dtype=torch.float32):
    """Four U[0, 1) fields (the top 24 bits of each word) from the counters,
    in ``dtype``."""
    return tuple(((v >> 8).to(torch.float32) * INV24).to(dtype) for v in pcg4d(lane, sample, salt, seed))


def pass_seed(seed: int, pass_index: int) -> int:
    """The u32 seed of pass ``pass_index`` of a render seeded with ``seed``:
    the first word of (seed, pass_index, "PASS", 0)."""
    return pcg4d(seed & M32, pass_index & M32, PASS_SALT, 0)[0]
