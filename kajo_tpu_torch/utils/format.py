"""SI-suffix formatting for throughput lines (port of ``kajo_tpu/utils/format.py``)."""

from __future__ import annotations


def format_si(value: float) -> str:
    """1234567 -> '1.23M', in the reference preview's K/M/G style."""
    for suffix, scale in (("G", 1e9), ("M", 1e6), ("K", 1e3)):
        if abs(value) >= scale:
            return f"{value / scale:.2f}{suffix}"
    return f"{value:.0f}"
