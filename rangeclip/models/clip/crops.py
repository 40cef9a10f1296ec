"""Object-crop preparation for the area-image contrastive pathway.

Reference: dataloader.py:238-284 — per item, crop the processed RGB by the
object bbox, run the crops through CLIPProcessor (resize shortest side to
224 + center crop) and the frozen CLIP image tower.

Reformulation: the python crop loop + ragged CLIPProcessor batch
become a single fixed-shape gather.  CLIPProcessor's resize-shortest-side +
center-crop composition is equivalent to sampling the largest centered
square inside the bbox and bilinearly resizing it to 224x224 — which is
exactly what the sampling grid below does, entirely on device, batched, with
static shapes (bboxes are traced values, so crops of any size never
recompile).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_normalize(images: jax.Array) -> jax.Array:
    """[..., 3] images in [0,1] -> CLIP-normalized."""
    mean = jnp.asarray(CLIP_MEAN, images.dtype)
    std = jnp.asarray(CLIP_STD, images.dtype)
    return (images - mean) / std


def _sample_bilinear(image: jax.Array, ys: jax.Array, xs: jax.Array) -> jax.Array:
    """Sample image [H, W, C] at fractional coords ys [S], xs [S] -> [S, S, C]."""
    H, W, _ = image.shape
    y0 = jnp.clip(jnp.floor(ys).astype(jnp.int32), 0, H - 1)
    y1 = jnp.clip(y0 + 1, 0, H - 1)
    x0 = jnp.clip(jnp.floor(xs).astype(jnp.int32), 0, W - 1)
    x1 = jnp.clip(x0 + 1, 0, W - 1)
    wy = (ys - y0.astype(ys.dtype))[:, None, None]
    wx = (xs - x0.astype(xs.dtype))[None, :, None]

    top = image[y0][:, x0] * (1 - wx) + image[y0][:, x1] * wx
    bot = image[y1][:, x0] * (1 - wx) + image[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def prepare_image_crops(
    images: jax.Array,
    bboxes: jax.Array,
    out_size: int = 224,
    normalize: bool = True,
) -> jax.Array:
    """Extract CLIP-ready square crops.

    Args:
      images: [B, H, W, 3] float in [0, 1].
      bboxes: [B, 4] int (xmin, ymin, xmax, ymax) in pixel coords.
      out_size: output side (CLIP's 224).

    Returns: [B, out_size, out_size, 3], CLIP-normalized when requested.
    """

    def crop_one(image: jax.Array, bbox: jax.Array) -> jax.Array:
        xmin, ymin, xmax, ymax = (bbox[0], bbox[1], bbox[2], bbox[3])
        bw = (xmax - xmin).astype(jnp.float32)
        bh = (ymax - ymin).astype(jnp.float32)
        side = jnp.maximum(jnp.minimum(bw, bh), 1.0)
        cy = (ymin.astype(jnp.float32) + ymax.astype(jnp.float32)) / 2.0
        cx = (xmin.astype(jnp.float32) + xmax.astype(jnp.float32)) / 2.0
        # centered square of the bbox; half-pixel sampling grid
        t = (jnp.arange(out_size, dtype=jnp.float32) + 0.5) / out_size - 0.5
        ys = cy + t * side - 0.5
        xs = cx + t * side - 0.5
        return _sample_bilinear(image, ys, xs)

    crops = jax.vmap(crop_one)(images.astype(jnp.float32), bboxes)
    return clip_normalize(crops) if normalize else crops
