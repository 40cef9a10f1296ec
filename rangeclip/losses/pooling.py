"""Masked average pooling of pixel embeddings over segmentation masks.

Reference: model.py:15-56 (module-level ``masked_average_pooling`` — pools
across the whole batch per object index) and dataloader.py:287-304 (per-item
pooling inside ``prepare_image_contrast_data``).

Array formulation: the reference loops over object indices comparing the
whole segmentation map each iteration; here the (mask . embeddings)
contraction is a single matmul:
  match [N, B*H*W] = (seg_flat == object_indices[:, None])
  sums  [N, D]     = match @ emb_flat
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def masked_average_pooling(
    pixel_embeddings: jax.Array,
    segmentation_map: jax.Array,
    object_indices: jax.Array,
) -> jax.Array:
    """Batch-global pooling (model.py:15-56).

    Args:
      pixel_embeddings: [B, H, W, D].
      segmentation_map: [B, H, W] int.
      object_indices: [N] int.

    Returns: [N, D]; rows are zero for objects absent from the batch.
    """
    B, H, W, D = pixel_embeddings.shape
    emb_flat = pixel_embeddings.reshape(B * H * W, D).astype(jnp.float32)
    seg_flat = segmentation_map.reshape(B * H * W)
    match = (seg_flat[None, :] == object_indices[:, None]).astype(jnp.float32)
    sums = jnp.einsum(
        "np,pd->nd", match, emb_flat, preferred_element_type=jnp.float32
    )
    counts = jnp.sum(match, axis=1, keepdims=True)
    return jnp.where(counts > 0, sums / jnp.maximum(counts, 1.0), 0.0)


def per_item_masked_pooling(
    pixel_embeddings: jax.Array,
    segmentation_map: jax.Array,
    labels: jax.Array,
    upsample: int = 1,
) -> jax.Array:
    """Per-batch-item pooling (dataloader.py:287-304): item b's area embedding
    averages its own pixels where ``segmentation[b] == labels[b]``.

    Args:
      pixel_embeddings: [B, H, W, D].
      segmentation_map: [B, H, W] int — or [B, s*H, s*W] with ``upsample=s``
        (native-resolution training): pooling the nearest xs upsampled field
        over the full-res mask equals pooling the native field with per-pixel
        child counts as weights (exact identity; the sxs sum-pool of the
        mask runs on a scalar field, not the D-channel embeddings).
      labels: [B] int (the chosen object per item).

    Returns: [B, D]; zero rows where the label covers no pixels.
    """
    mask = (segmentation_map == labels[:, None, None]).astype(jnp.float32)
    if upsample > 1:
        B = mask.shape[0]
        h = mask.shape[1] // upsample
        w = mask.shape[2] // upsample
        mask = mask.reshape(B, h, upsample, w, upsample).sum(axis=(2, 4))
    sums = jnp.einsum(
        "bhw,bhwd->bd", mask, pixel_embeddings.astype(jnp.float32),
        preferred_element_type=jnp.float32,
    )
    counts = jnp.sum(mask, axis=(1, 2), keepdims=False)[:, None]
    return jnp.where(counts > 0, sums / jnp.maximum(counts, 1.0), 0.0)
