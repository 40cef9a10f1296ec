"""Host-side (numpy) sample transforms.

Reference: dataloader.py:18-84 —
  * image: bilinear resize to (H, W) (torchvision Resize);
  * depth: nearest resize then divide by the median, with a zero-guard when
    |median| < 1e-6 (:49-54).  torch.median returns the LOWER of the two
    middle order statistics for even counts — replicated here (numpy's
    median averages them, which would silently change normalization for
    even-sized maps);
  * segmentation: nearest resize keeping integer labels.

All run on the host CPU inside loader workers, producing fixed-shape float32
/ int32 arrays ready for device put.  Nearest resize uses torch's index rule
idx = floor(i * in/out).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _nearest_idx(out_size: int, in_size: int) -> np.ndarray:
    idx = np.floor(np.arange(out_size) * (in_size / out_size)).astype(np.int64)
    return np.clip(idx, 0, in_size - 1)


def _resize_nearest_np(x: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """[H, W(, C)] nearest resize with torch index semantics."""
    H_out, W_out = size
    if x.shape[:2] == (H_out, W_out):
        return x
    rows = _nearest_idx(H_out, x.shape[0])
    cols = _nearest_idx(W_out, x.shape[1])
    return x[rows][:, cols]


def lower_median_np(x: np.ndarray) -> float:
    """torch.median semantics (lower middle order statistic)."""
    flat = np.sort(x.reshape(-1))
    return float(flat[(flat.size - 1) // 2])


def depth_transform(depth: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Nearest resize + median normalization (dataloader.py:23-61).

    Args: depth [H, W] float array.  Returns float32 [H, W].

    Uses the native C++ fast path (rangeclip/native) when built; the
    numpy path below is the same math.
    """
    from rangeclip.native import depth_transform_native

    native = depth_transform_native(depth, size)
    if native is not None:
        return native
    resized = _resize_nearest_np(depth.astype(np.float32), size)
    median = lower_median_np(resized)
    if abs(median) < 1e-6:
        return np.zeros_like(resized)
    return resized / median


def image_transform(image, size: Tuple[int, int]) -> np.ndarray:
    """Bilinear image resize to (H, W); returns float32 [H, W, 3] in [0, 1].

    (Reference uses torchvision Resize on the to_tensor'd image,
    dataloader.py:18-20; PIL bilinear is the matching classical resampler.)
    """
    from PIL import Image

    if isinstance(image, np.ndarray):
        arr = image
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
        image = Image.fromarray(arr)
    H, W = size
    resized = image.convert("RGB").resize((W, H), Image.BILINEAR)
    return np.asarray(resized, dtype=np.float32) / 255.0


def segmentation_transform(seg: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Nearest resize of an integer label map (dataloader.py:63-81)."""
    from rangeclip.native import segmentation_resize_native

    native = segmentation_resize_native(np.asarray(seg), size)
    if native is not None:
        return native
    return _resize_nearest_np(np.asarray(seg), size).astype(np.int32)
