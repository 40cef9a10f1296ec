"""Hybrid contrastive loss stack (pixel-text InfoNCE with curriculum
distractors, area-image InfoNCE, total-variation smoothness)."""

from rangeclip.losses.infonce import (
    sample_pixels,
    build_contrast_mask,
    pixel_text_infonce,
    area_image_infonce,
)
from rangeclip.losses.pooling import (
    masked_average_pooling,
    per_item_masked_pooling,
)
from rangeclip.losses.smoothness import total_variation_loss
from rangeclip.losses.hybrid import HybridLossConfig, compute_hybrid_loss

__all__ = [
    "sample_pixels",
    "build_contrast_mask",
    "pixel_text_infonce",
    "area_image_infonce",
    "masked_average_pooling",
    "per_item_masked_pooling",
    "total_variation_loss",
    "HybridLossConfig",
    "compute_hybrid_loss",
]
