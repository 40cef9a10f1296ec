"""Baseline evaluators — the metric-stack sanity oracles.

Reference: evaluation.py —
  * MajorityBaseline: constant-label prediction (:6-17) +
    evaluate_majority_model (:68-109);
  * RandomWithNegativesBaseline: uniform prediction over GT ∪ sampled
    negatives (:20-61) + evaluate_random_model (:111-154);
  * evaluate_mask_clip: MaskCLIP-style zero-shot dense probe — CLIP ViT
    patch tokens through visual_projection, upsampled, cosine-scored
    against a reduced text set (:162-237);
  * evaluate_seg_former: supervised RGB segmentation probe (:245-322) —
    takes any ``images -> [B, h, w, C_model]`` logits callable (an HF
    SegFormer adapter is provided) so the harness works without network
    access to model hubs.

All evaluators share the equivalence-aware metric stack.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from rangeclip.evals.metrics import metrics_finalize, metrics_init, metrics_update
from rangeclip.models.depth_unet import build_candidate_mask
from rangeclip.ops.resize import resize_bilinear
from rangeclip.utils.logging import log
from rangeclip.utils.math import l2_normalize


class MajorityBaseline:
    """Constant-label prediction (evaluation.py:6-17)."""

    def __init__(self, majority_label_index: int):
        self.majority_label_index = majority_label_index

    def predict(self, depth: jax.Array, top_k: int = 1) -> jax.Array:
        B, H, W = depth.shape[:3]
        return jnp.full((B, H, W, top_k), self.majority_label_index, jnp.int32)


class RandomWithNegativesBaseline:
    """Uniform prediction over GT ∪ sampled negatives (evaluation.py:20-61).

    Static-shape version: draws a candidate mask per item, then samples
    classes with probability proportional to mask membership.
    """

    def __init__(self, num_classes: int, num_negatives: int = 300):
        self.num_classes = num_classes
        self.num_negatives = num_negatives

    def predict(
        self, rng: jax.Array, segmentation: jax.Array, top_k: int = 1
    ) -> jax.Array:
        B, H, W = segmentation.shape

        def one(key, seg):
            k_mask, k_draw = jax.random.split(key)
            mask = build_candidate_mask(
                k_mask, seg, self.num_classes, self.num_negatives
            )
            logits = jnp.where(mask, 0.0, -jnp.inf)
            return jax.random.categorical(k_draw, logits, shape=(H, W, top_k))

        keys = jax.random.split(rng, B)
        return jax.vmap(one)(keys, segmentation).astype(jnp.int32)


def _run_metric_loop(predict_fn, dataloader, equivalence_tensor, equiv_class_map,
                     num_classes: int, log_path=None, name: str = "baseline"):
    acc = metrics_init(num_classes)
    et = jnp.asarray(equivalence_tensor)
    ecm = jnp.asarray(equiv_class_map)
    update = jax.jit(metrics_update)
    for i, batch in enumerate(dataloader):
        seg = jnp.asarray(batch["segmentation"])
        pred = predict_fn(i, batch, seg)
        acc = update(acc, pred, seg, et, ecm,
                     pixel_weight=jnp.asarray(batch["sample_valid"]))
    results = metrics_finalize(acc)
    log(f"[{name}] Pixel accuracy: {results['pixel_accuracy_t1']:.4f}", log_path)
    log(f"[{name}] mIoU: {results['mIoU_t1']:.4f}", log_path)
    return results


def evaluate_majority_model(
    dataloader, majority_label_index: int, equivalence_tensor, equiv_class_map,
    num_classes: int, log_path: Optional[str] = None,
) -> Dict[str, float]:
    model = MajorityBaseline(majority_label_index)
    return _run_metric_loop(
        lambda i, batch, seg: model.predict(jnp.asarray(batch["depth"])),
        dataloader, equivalence_tensor, equiv_class_map, num_classes,
        log_path, "Majority Baseline",
    )


def evaluate_random_model(
    dataloader, num_classes: int, equivalence_tensor, equiv_class_map,
    num_negatives: int = 300, seed: int = 0, log_path: Optional[str] = None,
) -> Dict[str, float]:
    model = RandomWithNegativesBaseline(num_classes, num_negatives)
    rng = jax.random.key(seed)
    return _run_metric_loop(
        lambda i, batch, seg: model.predict(jax.random.fold_in(rng, i), seg),
        dataloader, equivalence_tensor, equiv_class_map, num_classes,
        log_path, "Random Baseline",
    )


def evaluate_mask_clip(
    dataloader,
    vision_tower,
    vision_params,
    text_table: jax.Array,
    equivalence_tensor,
    equiv_class_map,
    num_classes: int,
    num_negatives: int = 50,
    top_k: int = 5,
    seed: int = 0,
    log_path: Optional[str] = None,
) -> Dict[str, float]:
    """MaskCLIP-style dense zero-shot probe (evaluation.py:162-237):
    projected ViT patch tokens, bilinearly upsampled to image resolution,
    cosine-scored against the reduced candidate text set."""
    rng = jax.random.key(seed)
    text_n = l2_normalize(jnp.asarray(text_table, jnp.float32), axis=-1)

    @jax.jit
    def predict(params, images, seg, key):
        patches = vision_tower.apply({"params": params}, images, True)
        dense = resize_bilinear(patches, seg.shape[1:3])
        dense = l2_normalize(dense, axis=-1)
        logits = jnp.einsum("bhwd,cd->bhwc", dense, text_n,
                            preferred_element_type=jnp.float32)
        mask = build_candidate_mask(key, seg, num_classes, num_negatives)
        logits = jnp.where(mask[None, None, None], logits, -1e30)
        return jax.lax.top_k(logits, top_k)[1].astype(jnp.int32)

    from rangeclip.models.clip.crops import clip_normalize

    def predict_fn(i, batch, seg):
        images = clip_normalize(jnp.asarray(batch["image"]))
        return predict(vision_params, images, seg, jax.random.fold_in(rng, i))

    return _run_metric_loop(
        predict_fn, dataloader, equivalence_tensor, equiv_class_map, num_classes,
        log_path, "MaskCLIP Probe",
    )


def evaluate_seg_former(
    dataloader,
    logits_fn,
    num_classes: int,
    equivalence_tensor=None,
    num_negatives: int = 300,
    seed: int = 0,
    log_path: Optional[str] = None,
) -> float:
    """Supervised RGB segmentation probe (evaluation.py:245-322).

    ``logits_fn(images_hwc_float01) -> [B, h, w, C_model]`` per-class logits
    (any resolution; they are bilinearly resized to the GT shape, reference
    :291).  Predictions are restricted to GT labels plus ``num_negatives``
    sampled distractors (:294-305) and scored with equivalence-aware pixel
    accuracy (:311-316).  Returns the pixel accuracy (the reference reports
    only this scalar, :319-322).
    """
    rng = jax.random.key(seed)
    et = jnp.asarray(equivalence_tensor) if equivalence_tensor is not None else None

    correct = 0.0
    total = 0.0
    for i, batch in enumerate(dataloader):
        images = np.asarray(batch["image"], np.float32)
        if not np.isfinite(images).all():
            # NaN/Inf image guard (reference :265-277 skips such images)
            images = np.nan_to_num(images, nan=0.0, posinf=1.0, neginf=0.0)
        images = np.clip(images, 0.0, 1.0)
        seg = jnp.asarray(batch["segmentation"])

        logits = jnp.asarray(logits_fn(images), jnp.float32)  # [B, h, w, Cm]
        logits = resize_bilinear(logits, seg.shape[1:3])

        # Restrict to GT ∪ sampled distractors via a static [C] mask
        # (reference gathers a python-sorted reduced index list, :294-305;
        # masked argmax over the full class axis is equivalent).
        mask = build_candidate_mask(
            jax.random.fold_in(rng, i), seg, num_classes, num_negatives
        )
        C_model = logits.shape[-1]
        mask = mask[:C_model] if C_model <= num_classes else jnp.pad(
            mask, (0, C_model - num_classes), constant_values=False
        )
        logits = jnp.where(mask[None, None, None, :], logits, -jnp.inf)
        preds = jnp.argmax(logits, axis=-1).astype(jnp.int32)

        gt_flat = seg.reshape(-1)
        pred_flat = preds.reshape(-1)
        # Fixed-shape final batches pad by repeating samples with
        # sample_valid=0 (data/loader.py) — weight pixels so padding
        # doesn't bias the accuracy (the other evaluators pass the same
        # weights into metrics_update).
        valid = np.asarray(
            batch.get("sample_valid", np.ones(seg.shape[0])), np.float32
        )
        pixel_w = jnp.repeat(
            jnp.asarray(valid), int(np.prod(seg.shape[1:]))
        )
        if et is not None:
            correct += float(jnp.sum(et[gt_flat, pred_flat] * pixel_w))
        else:
            correct += float(jnp.sum((gt_flat == pred_flat) * pixel_w))
        total += float(jnp.sum(pixel_w))

    pixel_accuracy = correct / total if total > 0 else 0.0
    log(
        f"[SegFormer Evaluation] Pixel accuracy "
        f"(GT + {num_negatives} distractors): {pixel_accuracy:.4f}",
        log_path,
    )
    return pixel_accuracy


def hf_segformer_logits_fn(model_name_or_path: str, device: str = "cpu"):
    """Adapter: HF torch SegFormer -> ``logits_fn`` for
    :func:`evaluate_seg_former`.  Requires locally available weights (this
    framework makes no network calls)."""
    import torch
    from transformers import AutoImageProcessor, SegformerForSemanticSegmentation

    processor = AutoImageProcessor.from_pretrained(model_name_or_path)
    model = SegformerForSemanticSegmentation.from_pretrained(model_name_or_path)
    model.eval().to(device)

    def logits_fn(images_hwc: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            inputs = processor(
                images=list(images_hwc), return_tensors="pt", do_rescale=False
            ).to(device)
            out = model(**inputs).logits  # [B, Cm, h, w]
        return out.permute(0, 2, 3, 1).cpu().numpy()

    return logits_fn
