"""The port's image helpers (``kajo_tpu_torch.utils.image``) against the
JAX package's (``kajo_tpu.utils.image``) on one seeded HDR image.

The port's gamma, tone map and PNG encoder are ``kajo_tpu``'s Python path
bit for bit. ``kajo_tpu``'s ``save_png`` goes through its native C runtime
where that builds, whose tone map differs from the Python one by at most
one step on under 1% of the bytes (``powf`` against ``np.power``), the bar
of ``tests/test_image_runtime.py``. ``load_png`` reads what either
package's encoders write as PIL reads it, and refuses every other PNG.
"""

import struct
import zlib

import numpy as np
import pytest

from kajo_tpu.utils import image as jax_image
from kajo_tpu_torch.utils import image


@pytest.fixture(scope="module")
def hdr():
    rng = np.random.default_rng(0)
    return rng.uniform(-0.2, 2.0, (17, 23, 4)).astype(np.float32)


def _varied_alpha(rgba8: np.ndarray) -> np.ndarray:
    rgba8 = rgba8.copy()
    rgba8[..., 3] = np.arange(rgba8[..., 3].size).reshape(rgba8.shape[:2]) % 256
    return rgba8


def test_tonemap_and_gamma_equal_kajo_tpu(hdr):
    np.testing.assert_array_equal(image.tonemap(hdr), jax_image.tonemap(hdr))
    clamped = np.clip(hdr, 0.0, 1.0)
    np.testing.assert_array_equal(image.linear_to_srgb(clamped), jax_image.linear_to_srgb(clamped))


def test_encode_png_equals_kajo_tpu(hdr):
    rgba8 = _varied_alpha(image.tonemap(hdr))
    assert image.encode_png(rgba8) == jax_image.encode_png(rgba8)
    with pytest.raises(ValueError, match="uint8"):
        image.encode_png(rgba8[..., :3])


def test_save_png_writes_the_stdlib_png(hdr, tmp_path):
    """The port saves through its stdlib encoder; kajo_tpu's save (native
    runtime or Python) shows the same image within one step."""
    ours, theirs = tmp_path / "ours.png", tmp_path / "theirs.png"
    image.save_png(str(ours), hdr)
    assert ours.read_bytes() == image.encode_png(image.tonemap(hdr))
    jax_image.save_png(str(theirs), hdr)
    diff = np.abs(jax_image.load_png(str(ours)).astype(int) - jax_image.load_png(str(theirs)).astype(int))
    assert diff.max() <= 1 and (diff != 0).mean() < 0.01


@pytest.mark.parametrize("writer", ["port-encode_png", "kajo_tpu-encode_png", "kajo_tpu-save_png"])
def test_load_png_equals_kajo_tpu(hdr, tmp_path, writer):
    path = tmp_path / f"{writer}.png"
    rgba8 = _varied_alpha(image.tonemap(hdr))
    if writer == "kajo_tpu-save_png":
        jax_image.save_png(str(path), hdr)
    else:
        path.write_bytes((image if writer.startswith("port") else jax_image).encode_png(rgba8))
    got = image.load_png(str(path))
    np.testing.assert_array_equal(got, jax_image.load_png(str(path)))
    if writer != "kajo_tpu-save_png":
        np.testing.assert_array_equal(got, rgba8)


def _png(ihdr: tuple, raw: bytes) -> bytes:
    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    return (image.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", *ihdr)) + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


W, H = 5, 6
GOOD = _png((W, H, 8, 6, 0, 0, 0), bytes(H * (4 * W + 1)))
REFUSED = {
    "not-png": (b"GIF89a" + GOOD[6:], "not a PNG"),
    "truncated": (GOOD[:-20], "truncated"),
    "interlaced": (_png((W, H, 8, 6, 0, 0, 1), bytes(H * (4 * W + 1))), "interlace 1"),
    "16-bit": (_png((W, H, 16, 6, 0, 0, 0), bytes(H * (8 * W + 1))), "bit depth 16"),
    "palette": (_png((W, H, 8, 3, 0, 0, 0), bytes(H * (W + 1))), "color type 3"),
    "rgb": (_png((W, H, 8, 2, 0, 0, 0), bytes(H * (3 * W + 1))), "color type 2"),
    "grey": (_png((W, H, 8, 0, 0, 0, 0), bytes(H * (W + 1))), "color type 0"),
    "short-data": (_png((W, H, 8, 6, 0, 0, 0), bytes(H * 4 * W)), "bytes of image data"),
    "corrupt-data": (GOOD[:41] + b"\xff" * 4 + GOOD[45:], "corrupt image data"),
    **{
        f"filter-{k}": (_png((W, H, 8, 6, 0, 0, 0), b"".join(bytes([k]) + bytes(4 * W) for _ in range(H))),
                        f"filter type {k}")
        for k in range(1, 6)
    },
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_load_png_refuses_other_pngs(tmp_path, case):
    data, message = REFUSED[case]
    path = tmp_path / f"{case}.png"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=message):
        image.load_png(str(path))

