"""Port PCG4D against kajo_tpu.ops.rng: bit for bit over random u32 counters,
including values >= 2**31 (the port computes in int64 masked to 32 bits)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kajo_tpu.ops import rng as jax_rng
from kajo_tpu_torch.ops import rng


def _counters(seed, n=4096):
    r = np.random.default_rng(seed)
    c = r.integers(0, 2**32, size=(4, n), dtype=np.uint64).astype(np.uint32)
    c[:, :4] = [[0, 2**31, 2**32 - 1, 2**31 - 1]] * 4  # the edges
    return c


@pytest.mark.parametrize("seed", [0, 1])
def test_pcg4d_bitwise(seed):
    c = _counters(seed)
    want = jax_rng.pcg4d(*(jnp.asarray(x) for x in c))
    got = rng.pcg4d(*(torch.from_numpy(x.astype(np.int64)) for x in c))
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy().astype(np.uint32), np.asarray(w))
        assert g.min() >= 0 and g.max() < 2**32


@pytest.mark.parametrize("seed", [2, 3])
def test_uniforms4_bitwise(seed):
    c = _counters(seed)
    want = jax_rng.uniforms4(*(jnp.asarray(x) for x in c))
    got = rng.uniforms4(*(torch.from_numpy(x.astype(np.int64)) for x in c))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert g.min() >= 0 and g.max() < 1


def test_python_int_counters_match_tensors():
    got = rng.pcg4d(7, 2**31 + 5, rng._PASS_SALT, 2**32 - 1)
    want = rng.pcg4d(*(torch.tensor([v], dtype=torch.int64) for v in (7, 2**31 + 5, rng._PASS_SALT, 2**32 - 1)))
    assert list(got) == [int(w) for w in want]


def test_pass_seed_is_a_counter_hash():
    seeds = [rng.pass_seed(0, p) for p in range(64)]
    assert len(set(seeds)) == 64
    assert all(0 <= s < 2**32 for s in seeds)
    # a pure function of (seed, pass): resuming at pass p needs no state
    assert rng.pass_seed(0, 17) == seeds[17]
    assert rng.pass_seed(1, 17) != seeds[17]
    assert rng.pass_seed(2**32 + 3, 5) == rng.pass_seed(3, 5)
