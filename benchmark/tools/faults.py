"""Faults planted under the timed path, to see that the comparison catches
them (``benchmark/tests/test_bench_faults.py`` on the CPU,
``benchmark/tools/control.py`` on the card). Each ``wrap_*`` takes an
engine's batch entry ``(scene, seed, first_pass, W, H, spp, n_passes,
config) -> [H, W, 4]`` and returns a broken one; :func:`altered_lane`
breaks K1's output where it is produced.
"""

from __future__ import annotations

import contextlib

import torch


def wrap_unchanged(entry):
    """A batch that leaves the host's sum as it was: its image is zero."""

    def broken(*args):
        return torch.zeros_like(entry(*args))

    return broken


def wrap_stale(entry):
    """Every batch after the first returns the first batch's image."""
    first = []

    def broken(*args):
        img = entry(*args)
        if not first:
            first.append(img.clone())
        return first[0].clone()

    return broken


def wrap_half(entry):
    """Half of a batch's passes left out, the others scaled to the batch's
    whole (their mean times the batch's passes)."""

    def broken(scene, seed, first_pass, width, height, spp, n_passes, config):
        kept = max(n_passes // 2, 1)
        return entry(scene, seed, first_pass, width, height, spp, kept, config) * (n_passes / kept)

    return broken


@contextlib.contextmanager
def altered_lane(lane: int, factor: float = 2.0):
    """K1's sums of ``lane`` multiplied by ``factor`` in every pass, where
    the megakernel's lane sums are produced."""
    from kajo_tpu_torch.ops import megakernel

    original = megakernel.lane_sums

    def broken(ps, seed):
        sums = original(ps, seed).clone()
        sums[:, lane - ps.lane0] *= factor
        return sums

    megakernel.lane_sums = broken
    try:
        yield
    finally:
        megakernel.lane_sums = original


WRAPS = {"unchanged": wrap_unchanged, "stale": wrap_stale, "half": wrap_half}
