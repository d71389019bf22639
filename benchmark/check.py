"""The comparison that decides ``correct``.

A checked batch is judged by the running sum on the host after it: the sum
before it (zero for the window's first batch, the program's own sum
otherwise) plus the reference's image of the batch's passes, added in
float32 as the host adds. Two numbers, each the worst over the checked
batches:

- ``px_gap``: the largest gap of any pixel and channel, over the mean of the
  reference image's RGB: one answer altered where it is produced shows here;
- ``mean_gap``: the sum of the gaps over the sum of the reference image,
  RGBA: a batch left out, repeated or rendered in part shows here.

A number that is not finite reads as infinite.
"""

from __future__ import annotations

import math

import numpy as np


def gaps(after: np.ndarray, start: np.ndarray, ref: np.ndarray) -> dict:
    """The numbers of one checked batch: ``after`` the program's host sum
    after the batch, ``start`` the sum before it, ``ref`` the reference's
    image of the batch (float32 [H, W, 4] each)."""
    want = (start.astype(np.float32) + ref.astype(np.float32)).astype(np.float64)
    diff = np.abs(after.astype(np.float64) - want)
    rgb = float(np.abs(ref[..., :3].astype(np.float64)).mean())
    total = float(np.abs(ref.astype(np.float64)).sum())
    out = {
        "px_gap": float(diff.max()) / rgb if rgb > 0 else math.inf,
        "mean_gap": float(diff.sum()) / total if total > 0 else math.inf,
    }
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def worst(readings: list) -> dict:
    """The largest reading of each number over the checked batches."""
    return {k: max(r[k] for r in readings) for k in readings[0]} if readings else {}


def judge(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} of every number that has a limit; a number
    without a reading reads infinite."""
    return {k: {"value": numbers.get(k, math.inf), "limit": v} for k, v in limits.items()}


def passed(checks: dict) -> bool:
    return bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
