"""Resize primitives vs torch F.interpolate oracles (parity requirement:
reference depth/seg resizing uses torch nearest, ASPP/decoder use bilinear
align_corners=True)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as TF

from rangeclip.ops.resize import (
    resize_nearest,
    resize_bilinear,
    resize_bilinear_align_corners,
)


def _nhwc(x_nchw: np.ndarray) -> np.ndarray:
    return np.transpose(x_nchw, (0, 2, 3, 1))


@pytest.mark.parametrize(
    "in_hw,out_hw",
    [((7, 7), (224, 224)), ((112, 112), (224, 224)), ((13, 9), (29, 31)),
     ((224, 224), (56, 56)), ((5, 5), (5, 5))],
)
def test_nearest_matches_torch(in_hw, out_hw):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, *in_hw)).astype(np.float32)
    want = TF.interpolate(torch.from_numpy(x), size=out_hw, mode="nearest").numpy()
    got = np.asarray(resize_nearest(_nhwc(x), out_hw))
    np.testing.assert_array_equal(got, _nhwc(want))


@pytest.mark.parametrize(
    "in_hw,out_hw",
    [((1, 1), (14, 14)), ((7, 9), (14, 18)), ((14, 14), (7, 7)), ((5, 3), (16, 11))],
)
def test_bilinear_align_corners_matches_torch(in_hw, out_hw):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, *in_hw)).astype(np.float32)
    want = TF.interpolate(
        torch.from_numpy(x), size=out_hw, mode="bilinear", align_corners=True
    ).numpy()
    got = np.asarray(resize_bilinear_align_corners(_nhwc(x), out_hw))
    np.testing.assert_allclose(got, _nhwc(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "in_hw,out_hw", [((7, 9), (14, 18)), ((14, 14), (7, 7)), ((5, 3), (16, 11))]
)
def test_bilinear_half_pixel_matches_torch(in_hw, out_hw):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, *in_hw)).astype(np.float32)
    want = TF.interpolate(
        torch.from_numpy(x), size=out_hw, mode="bilinear", align_corners=False
    ).numpy()
    got = np.asarray(resize_bilinear(_nhwc(x), out_hw))
    np.testing.assert_allclose(got, _nhwc(want), rtol=1e-6, atol=1e-6)
