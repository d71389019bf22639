"""Terminal live preview (port of ``kajo_tpu/utils/preview.py``): the
progressive accumulation drawn with 24-bit-color half-block characters (two
pixels per cell), with a status line."""

from __future__ import annotations

import sys

import numpy as np

from .image import tonemap


def _downsample(rgb8: np.ndarray, max_cols: int, max_rows: int) -> np.ndarray:
    h, w, _ = rgb8.shape
    # two image rows per terminal row (half blocks)
    scale = max(1, -(-w // max_cols), -(-h // (2 * max_rows)))
    hh = (h // (2 * scale)) * 2 * scale
    ww = (w // scale) * scale
    img = rgb8[:hh, :ww].reshape(hh // scale, scale, ww // scale, scale, 3)
    return img.mean(axis=(1, 3)).astype(np.uint8)


def render_ansi(radiance: np.ndarray, max_cols: int = 96, max_rows: int = 36) -> str:
    """Tone-map and format the image as ANSI half-block art."""
    small = _downsample(tonemap(radiance)[..., :3], max_cols, max_rows)
    rows = []
    for y in range(0, small.shape[0] - 1, 2):
        cells = []
        for x in range(small.shape[1]):
            tr, tg, tb = small[y, x]
            br, bg, bb = small[y + 1, x]
            cells.append(f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀")
        rows.append("".join(cells) + "\x1b[0m")
    return "\n".join(rows)


def show(radiance: np.ndarray, status: str = "", out=sys.stderr) -> None:
    out.write("\x1b[H\x1b[2J" + render_ansi(radiance) + "\n" + status + "\n")
    out.flush()
