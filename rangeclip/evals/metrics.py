"""Equivalence-aware segmentation metrics, fully vectorized.

Reference: validate.py:95-139 —
  * top-1 / top-k pixel accuracy through the [C, C] equivalence lookup;
  * top-1 mIoU over equivalence-mapped labels;
  * top-k "oracle" mIoU: a pixel's prediction is replaced by its GT
    equivalence class when ANY of the top-k predictions matches it;
    unmatched pixels keep the RAW top-1 label (not its equivalence class) —
    a reference quirk replicated here for metric parity (validate.py:123-131).

The reference accumulates per-label dicts with python loops over
``unique_equiv_labels`` per batch; here every accumulator is a fixed [C]
array updated with scatter-adds, so a whole batch's metric update is one
fused XLA program.

Divergence (documented): the reference's final mIoU filters classes by the
GT labels of the *last* batch only (validate.py:206-207 — a latent bug); we
filter by GT-equivalence classes present anywhere in the evaluated set,
which is the evident intent.

All update math runs in int32/float32 and supports a per-pixel weight so
padded samples (fixed-shape final batches) drop out exactly.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp


def metrics_init(num_classes: int) -> Dict[str, jax.Array]:
    zc = jnp.zeros((num_classes,), jnp.float32)
    return {
        "correct_top1": jnp.float32(0.0),
        "correct_topk": jnp.float32(0.0),
        "total_pixels": jnp.float32(0.0),
        "intersection_top1": zc,
        "union_top1": zc,
        "intersection_topk": zc,
        "union_topk": zc,
        "gt_present": jnp.zeros((num_classes,), jnp.bool_),
    }


def metrics_update(
    acc: Dict[str, jax.Array],
    pred_topk: jax.Array,
    gt: jax.Array,
    equivalence_tensor: jax.Array,
    equiv_class_map: jax.Array,
    pixel_weight: Optional[jax.Array] = None,
) -> Dict[str, jax.Array]:
    """Accumulate one batch.

    Args:
      pred_topk: [B, H, W, k] int predicted global label indices (descending
        score order; [..., 0] is top-1).
      gt: [B, H, W] int ground truth.
      equivalence_tensor: [C, C] bool (gt, pred) -> equivalent.
      equiv_class_map: [C] int label -> representative class id.
      pixel_weight: optional [B] or [B, H, W] float mask (0 = ignore).
    """
    B, H, W, k = pred_topk.shape
    C = equivalence_tensor.shape[0]
    n = B * H * W

    gt_flat = gt.reshape(n)
    topk_flat = pred_topk.reshape(n, k)
    top1_flat = topk_flat[:, 0]

    if pixel_weight is None:
        w = jnp.ones((n,), jnp.float32)
    else:
        if pixel_weight.ndim == 1:
            pixel_weight = pixel_weight[:, None, None] * jnp.ones((B, H, W))
        w = pixel_weight.reshape(n).astype(jnp.float32)

    # --- pixel accuracy through the equivalence lookup (validate.py:95-103)
    correct1 = equivalence_tensor[gt_flat, top1_flat].astype(jnp.float32)
    correctk = equivalence_tensor[gt_flat[:, None], topk_flat].any(axis=1)
    correctk = correctk.astype(jnp.float32)

    # --- equivalence-mapped labels
    gt_e = equiv_class_map[gt_flat]
    top1_e = equiv_class_map[top1_flat]
    topk_e = equiv_class_map[topk_flat]

    # --- top-1 IoU accumulators (validate.py:105-115)
    agree1 = (gt_e == top1_e).astype(jnp.float32) * w
    inter1 = jnp.zeros((C,), jnp.float32).at[gt_e].add(agree1)
    cnt_gt = jnp.zeros((C,), jnp.float32).at[gt_e].add(w)
    cnt_p1 = jnp.zeros((C,), jnp.float32).at[top1_e].add(w)
    union1 = cnt_gt + cnt_p1 - inter1

    # --- top-k oracle IoU (validate.py:117-139): match -> gt class,
    #     no match -> RAW top-1 label (reference quirk).
    match_k = (topk_e == gt_e[:, None]).any(axis=1)
    oracle = jnp.where(match_k, gt_e, top1_flat)
    agreek = (oracle == gt_e).astype(jnp.float32) * w
    interk = jnp.zeros((C,), jnp.float32).at[gt_e].add(agreek)
    cnt_or = jnp.zeros((C,), jnp.float32).at[oracle].add(w)
    unionk = cnt_gt + cnt_or - interk

    present = jnp.zeros((C,), jnp.bool_).at[gt_e].max(w > 0)

    return {
        "correct_top1": acc["correct_top1"] + jnp.sum(correct1 * w),
        "correct_topk": acc["correct_topk"] + jnp.sum(correctk * w),
        "total_pixels": acc["total_pixels"] + jnp.sum(w),
        "intersection_top1": acc["intersection_top1"] + inter1,
        "union_top1": acc["union_top1"] + union1,
        "intersection_topk": acc["intersection_topk"] + interk,
        "union_topk": acc["union_topk"] + unionk,
        "gt_present": acc["gt_present"] | present,
    }


def metrics_finalize(acc: Dict[str, jax.Array]) -> Dict[str, float]:
    """Reduce accumulators to scalar metrics (validate.py:192-214)."""

    def miou(inter, union):
        valid = (union > 0) & acc["gt_present"]
        ious = jnp.where(valid, inter / jnp.maximum(union, 1.0), 0.0)
        n = jnp.sum(valid.astype(jnp.float32))
        return jnp.where(n > 0, jnp.sum(ious) / jnp.maximum(n, 1.0), 0.0)

    total = jnp.maximum(acc["total_pixels"], 1.0)
    has_pixels = acc["total_pixels"] > 0
    return {
        "pixel_accuracy_t1": float(jnp.where(has_pixels, acc["correct_top1"] / total, 0.0)),
        "pixel_accuracy_tk": float(jnp.where(has_pixels, acc["correct_topk"] / total, 0.0)),
        "mIoU_t1": float(miou(acc["intersection_top1"], acc["union_top1"])),
        "mIoU_tk": float(miou(acc["intersection_topk"], acc["union_topk"])),
        "n_labels_t1": int(jnp.sum((acc["union_top1"] > 0).astype(jnp.int32))),
        "n_labels_tk": int(jnp.sum((acc["union_topk"] > 0).astype(jnp.int32))),
    }
