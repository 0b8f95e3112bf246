"""utils/png.py: the zlib + numpy PNG codec that replaced Pillow on the
repo's own paths (texture assets, glTF textures, screenshots)."""

import struct
import sys
import zlib

import numpy as np
import pytest

from tpu_raytracer.utils import png


def _img(c, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (7, 9, c),
                                                dtype=np.uint8)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_roundtrip(channels):
    img = _img(channels)
    np.testing.assert_array_equal(png.decode(png.encode(img)), img)


def _png_with_filter(img, ftype):
    """PNG bytes whose every scanline uses filter `ftype` (spec 9.2)."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int32)
    rows = []
    prev = np.zeros(w * c, np.int32)
    for y in range(h):
        cur = x[y]
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        pred = [np.zeros_like(cur), left, prev, (left + prev) >> 1,
                png._paeth(left, prev, ul)][ftype]
        rows.append(bytes([ftype]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes())
        prev = cur
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (png._SIG + png._chunk(b"IHDR", struct.pack(
                ">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + png._chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_decode_every_filter(ftype):
    img = _img(3, seed=ftype)
    np.testing.assert_array_equal(png.decode(_png_with_filter(img, ftype)),
                                  img)


def test_unsupported_png_raises():
    data = (png._SIG + png._chunk(b"IHDR", struct.pack(
        ">IIBBBBB", 2, 2, 16, 2, 0, 0, 0)) + png._chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="unsupported PNG"):
        png.decode(data)


def test_gltf_texture_decode_without_pillow(monkeypatch):
    """glTF images decode to RGBA through the codec; a JPEG says clearly
    that it needs Pillow when Pillow is absent."""
    from tpu_raytracer.scene import loader

    monkeypatch.setitem(sys.modules, "PIL", None)
    rgba = loader._decode_bytes(png.encode(_img(3)))
    assert rgba.shape == (7, 9, 4) and (rgba[:, :, 3] == 255).all()
    gray = loader._decode_bytes(png.encode(_img(1)))
    assert (gray[:, :, 0] == gray[:, :, 2]).all()
    with pytest.raises(ValueError, match="needs Pillow"):
        loader._decode_bytes(b"\xff\xd8\xff\xe0" + b"\x00" * 16)


def test_texture_resize_without_pillow(monkeypatch):
    from tpu_raytracer.scene import builder

    monkeypatch.setitem(sys.modules, "PIL", None)
    img = np.full((64, 32, 3), 128, np.uint8)
    out = builder._prep_texture(img, srgb=False)
    size = builder.TEXTURE_SIZE
    assert out.shape == (size, size, 3)
    np.testing.assert_allclose(out, 128 / 255.0, atol=1e-5)


def test_dense_asset_version_file_beside_bare_filename(tmp_path,
                                                       monkeypatch):
    """ensure_dense_asset with a bare filename writes its version file in
    the working directory instead of failing on os.makedirs('')."""
    from tpu_raytracer.models import dense_asset

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(dense_asset, "write_knot_glb",
                        lambda p: open(p, "wb").close())
    assert dense_asset.ensure_dense_asset("knot.glb") == "knot.glb"
    assert (tmp_path / "knot.glb.version").read_text() == str(
        dense_asset.ASSET_VERSION)
