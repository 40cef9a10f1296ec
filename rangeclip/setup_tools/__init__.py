"""Offline data-prep pipeline (L7 — the reference's ``setup/`` scripts).

Host-CPU numpy/PIL tools that produce the CSV/PNG artifacts the data layer
consumes, plus the CLIP-text similarity-set generator that can run its
embedding pass on the accelerator.
"""

from rangeclip.setup_tools.similarity_sets import generate_label_similarity_sets
from rangeclip.setup_tools.label_cleanup import cleanup_labels
from rangeclip.setup_tools.cropping import FastPatchGenerator, crop_patch
from rangeclip.setup_tools.pseudo_ground_truth import (
    cross_class_nms,
    generate_pseudo_ground_truth,
)
from rangeclip.setup_tools.patches import (
    select_balanced_classes,
    generate_detection_patches,
)

__all__ = [
    "generate_label_similarity_sets",
    "cleanup_labels",
    "FastPatchGenerator",
    "crop_patch",
    "cross_class_nms",
    "generate_pseudo_ground_truth",
    "select_balanced_classes",
    "generate_detection_patches",
]
