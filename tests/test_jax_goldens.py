"""The store of the JAX package's outputs (``tests/goldens/jax_ref/``,
``tests/jax_goldens.py``) against a live run: one stored entry, the JAX
megakernel pass on caustics at 8x6, recomputed here in Pallas interpret
mode and held to the stored bits. A machine whose JAX build gives other
bits fails here, not in a comparison that trusts the store."""

import os

import numpy as np
from jax_goldens import key_of, path_of
from torch_port import jax_megakernel_pass, jax_scene

W, H = 8, 6


def test_stored_pass_replays_live():
    args = (jax_scene("caustics.json", W / H), 3, W, H, 4, {})
    stored = jax_megakernel_pass(*args)
    assert os.path.exists(path_of(key_of(*jax_megakernel_pass.inputs(*args)))), "the entry is not in the store"
    live = jax_megakernel_pass.__wrapped__(*args)
    assert set(stored) == set(live) == {"img", "seed"}
    for k in live:
        want = np.asarray(live[k])
        assert stored[k].dtype == want.dtype and stored[k].shape == want.shape, k
        assert stored[k].tobytes() == want.tobytes(), k
    assert np.isfinite(stored["img"]).all() and stored["img"][..., :3].max() > 0
