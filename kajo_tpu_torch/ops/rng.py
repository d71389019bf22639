"""Counter-based per-lane RNG (PCG4D hash), port of ``kajo_tpu/ops/rng.py``.

PCG4D (Jarzynski & Olano, "Hash Functions for GPU Rendering", JCGT 2020)
maps four u32 counters (lane, sample, salt, seed) to four u32 words. It is
stateless, so a lane that regenerates mid-pass keeps a deterministic stream,
and the port's streams equal the JAX package's bit for bit for the same
counters.

PyTorch on the CPU has no ``uint32`` shift or add, so these functions take
and return ``int64`` tensors holding u32 values and mask to 32 bits after
every step. A product of two u32 values wraps in int64, and its low 32 bits
are still right. The CUDA kernel computes the same hash in ``uint32_t``.

The JAX CLI derives pass seeds from ``jax.random`` keys; the port does not
reimplement threefry. :func:`pass_seed` hashes (seed, pass index) instead,
so resuming at pass p needs no generator state. Tests that compare the two
packages hand both the same u32 seed.

The parity engine and the boundary terms draw as the JAX package's do,
through a key: ``fold_in``, ``split`` and ``uniform``. :class:`CounterKey`
is that key on PCG4D: a pure function of a u32 seed, the path of folds and
splits, and the index of each element drawn, so a seed gives the same
stream on the CPU and on the card. Any object with the same three methods
serves (the tests hand in one that wraps a ``jax.random`` key);
``render_image_fast`` also asks a key for ``seed()``, its u32 pass seed.
"""

from __future__ import annotations

import math
import numbers

import torch

_M32 = 0xFFFFFFFF
_INV24 = 1.0 / (1 << 24)
# salt of the pass-seed hash: "PASS" in ASCII
_PASS_SALT = 0x50415353
# salts of a key's derivations: "FOLD" and "SPLT" in ASCII
_FOLD_SALT, _SPLIT_SALT = 0x464F4C44, 0x53504C54


def pcg4d(a, b, c, d):
    """PCG4D: four u32 counters (int64 tensors or Python ints, broadcastable)
    -> four u32 words (int64 tensors, or Python ints when all four are)."""

    def lcg(v):
        if isinstance(v, torch.Tensor):
            v = v.to(torch.int64)
        return (v * 1664525 + 1013904223) & _M32

    x, y, z, w = lcg(a), lcg(b), lcg(c), lcg(d)
    x = (x + y * w) & _M32
    y = (y + z * x) & _M32
    z = (z + x * y) & _M32
    w = (w + y * z) & _M32
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = (x + y * w) & _M32
    y = (y + z * x) & _M32
    z = (z + x * y) & _M32
    w = (w + y * z) & _M32
    return x, y, z, w


def unit(u):
    """Top 24 bits of a u32 word -> float32 in [0, 1); exact."""
    return (u >> 8).to(torch.float32) * _INV24


def uniforms4(lane, sample, salt, seed):
    """Four independent U[0,1) fields from integer counters (broadcastable).
    ``salt`` disambiguates (bounce, purpose); ``seed`` is the pass seed."""
    return tuple(unit(v) for v in pcg4d(lane, sample, salt, seed))


def pass_seed(seed: int, pass_index: int) -> int:
    """u32 seed of progressive pass ``pass_index`` of a render seeded with
    ``seed``: the first PCG4D word of (seed, pass_index, "PASS", 0).

    A pure function of its two counters, so pass p of a resumed render gets
    the same seed as in an uninterrupted one."""
    return pcg4d(seed & _M32, pass_index & _M32, _PASS_SALT, 0)[0]


class CounterKey:
    """A key with ``jax.random``'s key API on PCG4D.

    The key is two u32 words, ``(seed, 0)`` at the root. ``fold_in(i)`` and
    ``split(n)`` hash the words with the index and a salt of their own;
    ``uniform`` hashes each element's flat index with the words."""

    __slots__ = ("words",)

    def __init__(self, seed: int = 0, words=None):
        self.words = (seed & _M32, 0) if words is None else words

    def _derive(self, i: int, salt: int) -> "CounterKey":
        x, y, _, _ = pcg4d(self.words[0], self.words[1], i & _M32, salt)
        return CounterKey(words=(x, y))

    def fold_in(self, i: int) -> "CounterKey":
        return self._derive(i, _FOLD_SALT)

    def split(self, n: int = 2) -> list:
        return [self._derive(i, _SPLIT_SALT) for i in range(n)]

    def seed(self) -> int:
        """The key as a u32 pass seed, by the JAX package's ``seed_from_key``
        rule: the first word xor the last shifted left by one."""
        return self.words[0] ^ ((self.words[1] << 1) & _M32)

    def uniform(self, shape, device, columns=None) -> torch.Tensor:
        """float32 U[0, 1) of ``shape`` on ``device``, 24 bits each; with
        ``columns`` = (lo, hi), only columns lo .. hi - 1 of the last axis
        of that draw (each element keeps its index in the whole draw)."""
        if columns is None:
            e = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
            return unit(pcg4d(e & _M32, e >> 32, *self.words)[0]).reshape(shape)
        lo, hi = columns
        rows = torch.arange(math.prod(shape[:-1]), dtype=torch.int64, device=device)
        e = rows[:, None] * shape[-1] + torch.arange(lo, hi, dtype=torch.int64, device=device)[None, :]
        return unit(pcg4d(e & _M32, e >> 32, *self.words)[0]).reshape(*shape[:-1], hi - lo)


def uniform_columns(key, shape, lo: int, hi: int, device) -> torch.Tensor:
    """Columns lo .. hi - 1 of the last axis of ``key.uniform(shape)``: a
    rank's block of a draw over every lane. A :class:`CounterKey` draws
    only those columns; another key draws the whole and slices it."""
    if isinstance(key, CounterKey):
        return key.uniform(shape, device, columns=(lo, hi))
    return key.uniform(shape, device)[..., lo:hi]


def as_key(seed_or_key):
    """A u32 seed as its :class:`CounterKey`; a key as it is."""
    return CounterKey(int(seed_or_key)) if isinstance(seed_or_key, numbers.Integral) else seed_or_key
