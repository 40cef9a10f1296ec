"""Native C++ preprocessing vs the numpy reference path."""

import numpy as np
import pytest

from rangeclip.data.transforms import _resize_nearest_np, lower_median_np
from rangeclip.native import (
    depth_transform_native,
    segmentation_resize_native,
    lib,
)


@pytest.mark.skipif(lib() is None, reason="native library unavailable")
def test_native_depth_transform_matches_numpy():
    rng = np.random.default_rng(0)
    for shape, size in [((37, 53), (24, 24)), ((480, 640), (224, 224)),
                        ((10, 10), (10, 10))]:
        d = rng.uniform(100, 5000, shape).astype(np.float32)
        got = depth_transform_native(d, size)
        resized = _resize_nearest_np(d, size)
        want = resized / lower_median_np(resized)
        np.testing.assert_allclose(got, want, rtol=1e-6)

    zeros = np.zeros((8, 8), np.float32)
    assert depth_transform_native(zeros, (4, 4)).sum() == 0


@pytest.mark.skipif(lib() is None, reason="native library unavailable")
def test_native_segmentation_resize_matches_numpy():
    rng = np.random.default_rng(1)
    s = rng.integers(0, 99, (123, 77)).astype(np.int32)
    got = segmentation_resize_native(s, (64, 224))
    np.testing.assert_array_equal(got, _resize_nearest_np(s, (64, 224)))


@pytest.mark.skipif(lib() is None, reason="native library unavailable")
def test_native_png_decode_matches_pil(tmp_path):
    """The zlib+unfilter PNG decoder is byte-identical to PIL on every
    shape the datasets produce; unsupported shapes return None (PIL
    fallback)."""
    from PIL import Image

    from rangeclip.native import decode_png_native

    rng = np.random.default_rng(0)

    p = str(tmp_path / "rgb.png")
    a = rng.integers(0, 256, (37, 53, 3), np.uint8)
    Image.fromarray(a).save(p)
    np.testing.assert_array_equal(
        decode_png_native(p), np.asarray(Image.open(p).convert("RGB")))

    p = str(tmp_path / "gray8.png")
    a = rng.integers(0, 256, (41, 29), np.uint8)
    Image.fromarray(a).save(p)
    np.testing.assert_array_equal(decode_png_native(p),
                                  np.asarray(Image.open(p)))

    # 16-bit grayscale: the PIL 'I'-mode save path used by depth/label PNGs
    p = str(tmp_path / "gray16.png")
    a = rng.integers(0, 65536, (33, 61), np.int32)
    Image.fromarray(a, mode="I").save(p)
    got = decode_png_native(p)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got.astype(np.int32),
                                  np.asarray(Image.open(p).convert("I")))

    # constant image exercises filter type runs / Up rows
    p = str(tmp_path / "flat.png")
    Image.fromarray(np.full((64, 64, 3), 7, np.uint8)).save(p)
    np.testing.assert_array_equal(
        decode_png_native(p), np.asarray(Image.open(p).convert("RGB")))

    # unsupported shapes -> None
    p = str(tmp_path / "rgba.png")
    Image.fromarray(rng.integers(0, 256, (10, 10, 4), np.uint8),
                    mode="RGBA").save(p)
    assert decode_png_native(p) is None
    p = str(tmp_path / "pal.png")
    Image.fromarray(rng.integers(0, 256, (10, 10), np.uint8)).convert(
        "P").save(p)
    assert decode_png_native(p) is None
    p = str(tmp_path / "x.jpg")
    Image.fromarray(a.astype(np.uint8)).convert("L").save(p, "JPEG")
    assert decode_png_native(p) is None
