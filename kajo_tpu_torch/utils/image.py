"""Image output: linear -> sRGB tone map and PNG encoding.

Port of ``kajo_tpu/utils/image.py`` with the reference's pixel math: clamp,
then gamma ``pow(c, 1/2.2)``, then ``c * 255 + .5`` truncated, alpha forced
opaque. The PNG goes through PIL when it is installed and through the
stdlib-zlib encoder below otherwise; both write the same pixels.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def tonemap(radiance: np.ndarray) -> np.ndarray:
    """Linear HDR [H, W, 4] -> uint8 RGBA (clamp -> gamma -> *255 + .5,
    alpha opaque)."""
    rgba = np.clip(np.asarray(radiance, np.float32), 0.0, 1.0)
    rgba = np.power(rgba, 1.0 / 2.2)
    rgba[..., 3] = 1.0
    return (rgba * 255.0 + 0.5).astype(np.uint8)


def encode_png(rgba8: np.ndarray) -> bytes:
    """Minimal RGBA8 PNG encoder (stdlib zlib only, filter 0)."""
    h, w, c = rgba8.shape
    if c != 4 or rgba8.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8 [H, W, 4], got {rgba8.dtype} {rgba8.shape}")

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    raw = b"".join(b"\x00" + rgba8[y].tobytes() for y in range(h))
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def save_png(path: str, radiance: np.ndarray) -> None:
    """Tone-map linear radiance [H, W, 4] and write it as a PNG."""
    rgba8 = tonemap(radiance)
    try:
        from PIL import Image
    except ImportError:
        with open(path, "wb") as f:
            f.write(encode_png(rgba8))
        return
    Image.fromarray(rgba8, "RGBA").save(path)
