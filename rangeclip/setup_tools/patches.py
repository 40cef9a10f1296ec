"""Detection-driven patch extraction with class balancing.

Reference: setup/generate_cropped_patches_void.py —
  * batch-level top-k class selection balancing inverse frequency (0.4) and
    confidence (0.6) (:58-90);
  * crops image+depth patches around surviving detections into per-class
    output directories (:229-245).

Also covers setup/nyu_depth_v2/generate_cropped_patches_nyu.py capability:
per-object contour bboxes padded by 20 px, crops resized to a fixed size
(bilinear image / nearest depth+label, :59-75), and a metadata.csv of
[image, depth, object_id] rows (:91-92).
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Dict, List, Sequence, Tuple

import numpy as np
from PIL import Image

from rangeclip.data.transforms import _resize_nearest_np


def select_balanced_classes(
    detections: np.ndarray,
    top_k: int,
    class_counts: Counter,
    w_frequency: float = 0.4,
    w_confidence: float = 0.6,
) -> np.ndarray:
    """Score detections by rarity + confidence, keep the top-k.

    detections: [N, 6] (cls, x, y, w, h, conf).
    """
    if len(detections) == 0:
        return detections.reshape(0, 6)
    total = max(sum(class_counts.values()), 1)
    rarity = np.array(
        [1.0 - class_counts.get(int(c), 0) / total for c in detections[:, 0]]
    )
    score = w_frequency * rarity + w_confidence * detections[:, 5]
    order = np.argsort(-score)[:top_k]
    return detections[order]


def bbox_from_mask(mask: np.ndarray, padding: int = 20) -> Tuple[int, int, int, int]:
    """Padded extent bbox of a boolean object mask (NYU variant :10-34)."""
    ys, xs = np.nonzero(mask)
    if ys.size == 0:
        return (0, 0, mask.shape[1], mask.shape[0])
    H, W = mask.shape
    return (
        max(0, int(xs.min()) - padding),
        max(0, int(ys.min()) - padding),
        min(W, int(xs.max()) + 1 + padding),
        min(H, int(ys.max()) + 1 + padding),
    )


def generate_detection_patches(
    image: np.ndarray,
    depth: np.ndarray,
    detections: np.ndarray,
    output_root: str,
    image_stem: str,
    class_names: Sequence[str],
    patch_size: Tuple[int, int] = (128, 128),
) -> List[Dict[str, str]]:
    """Write per-class image/depth patch PNGs; returns metadata rows."""
    H, W = image.shape[:2]
    rows = []
    for i, det in enumerate(detections):
        cls, x, y, w, h, _conf = det
        cls = int(cls)
        xmin = int(max(0, (x - w / 2) * W))
        xmax = int(min(W, (x + w / 2) * W))
        ymin = int(max(0, (y - h / 2) * H))
        ymax = int(min(H, (y + h / 2) * H))
        if xmax <= xmin or ymax <= ymin:
            continue
        cls_name = class_names[cls] if cls < len(class_names) else str(cls)
        cls_dir = os.path.join(output_root, cls_name)
        os.makedirs(cls_dir, exist_ok=True)

        img_patch = Image.fromarray(image[ymin:ymax, xmin:xmax]).resize(
            (patch_size[1], patch_size[0]), Image.BILINEAR
        )
        dep_patch = _resize_nearest_np(depth[ymin:ymax, xmin:xmax], patch_size)

        img_path = os.path.join(cls_dir, f"{image_stem}_{i}_image.png")
        dep_path = os.path.join(cls_dir, f"{image_stem}_{i}_depth.png")
        img_patch.save(img_path)
        Image.fromarray(dep_patch.astype(np.int32), mode="I").save(dep_path)
        rows.append({"image": img_path, "depth": dep_path, "object_id": str(cls)})
    return rows


def write_metadata_csv(rows: Sequence[Dict[str, str]], path: str) -> None:
    import csv

    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["image", "depth", "object_id"])
        w.writeheader()
        for row in rows:
            w.writerow(row)


def remove_small_classes(
    metadata_rows: Sequence[Dict[str, str]], min_count: int = 80
) -> List[Dict[str, str]]:
    """Prune classes with fewer than ``min_count`` patches
    (setup/remove_small_classes.py)."""
    counts = Counter(r["object_id"] for r in metadata_rows)
    return [r for r in metadata_rows if counts[r["object_id"]] >= min_count]
