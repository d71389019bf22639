"""Image output: linear -> sRGB tone map, PNG encoding and decoding.

Port of ``kajo_tpu/utils/image.py`` with the reference's pixel math: clamp,
then gamma ``pow(c, 1/2.2)``, then ``c * 255 + .5`` truncated, alpha forced
opaque. :func:`save_png` writes through the stdlib-zlib encoder below, and
:func:`load_png` reads what it writes back with no third-party package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def linear_to_srgb(color: np.ndarray) -> np.ndarray:
    """pow(c, 1/2.2) (the reference's Image.cpp gamma)."""
    return np.power(color, 1.0 / 2.2)


def tonemap(radiance: np.ndarray) -> np.ndarray:
    """Linear HDR [H, W, 4] -> uint8 RGBA (clamp -> gamma -> *255 + .5,
    alpha opaque)."""
    rgba = np.clip(np.asarray(radiance, np.float32), 0.0, 1.0)
    rgba = linear_to_srgb(rgba)
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
        PNG_SIGNATURE
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def save_png(path: str, radiance: np.ndarray) -> None:
    """Tone-map linear radiance [H, W, 4] and write it as a PNG (stdlib
    encoder: zlib at level 6 is nearly all of its time, and PIL is slower)."""
    with open(path, "wb") as f:
        f.write(encode_png(tonemap(radiance)))


def load_png(path: str) -> np.ndarray:
    """Read a PNG as :func:`encode_png` writes it (non-interlaced 8-bit
    RGBA, every row under filter 0) back as uint8 [H, W, 4]. Raises
    ValueError on any other PNG and on a truncated or corrupt file."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, header, idat = 8, None, []
    while True:
        if pos + 12 > len(data):
            raise ValueError(f"{path}: truncated before IEND")
        n, tag = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(data):
            raise ValueError(f"{path}: truncated {tag!r} chunk")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, compression, filtering, interlace = header
    if (depth, color, compression, filtering, interlace) != (8, 6, 0, 0, 0):
        raise ValueError(
            f"{path}: bit depth {depth}, color type {color}, interlace {interlace}: "
            "only non-interlaced 8-bit RGBA (color type 6) is read"
        )
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt image data: {e}") from e
    if len(raw) != h * (4 * w + 1):
        raise ValueError(f"{path}: {len(raw)} bytes of image data for {w}x{h}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, 4 * w + 1)
    filtered = np.flatnonzero(rows[:, 0])
    if filtered.size:
        y = int(filtered[0])
        raise ValueError(f"{path}: row {y} has filter type {rows[y, 0]}: only filter 0 is read")
    return rows[:, 1:].reshape(h, w, 4).copy()
