"""Spatial resize primitives with torch ``F.interpolate`` semantics.

The reference pipeline depends on three distinct resize behaviors:

  * nearest (``F.interpolate(mode='nearest')``): source index = floor(dst *
    in/out).  Used for depth/segmentation resizing
    (``dataloader.py:43-47,80``) and for the decoder's final upsample to the
    input resolution (``decoder.py:114``).  NOTE: jax.image.resize('nearest')
    rounds instead of flooring, so we implement the gather explicitly.
  * bilinear with align_corners=True: src = dst * (in-1)/(out-1).  Used for
    the ASPP global-pool branch upsample (``networks.py:43``) and decoder
    skip-shape adjustment (``decoder.py:201``).
  * bilinear with align_corners=False (half-pixel): src = (dst+0.5)*in/out-0.5.
    Provided for generality (CLIP preprocessing path).

All functions operate on NHWC arrays ([B, H, W, C]) and are jit-safe with
static output shapes.  They lower to two 1-D gathers + (for bilinear) four
fused multiply-adds — cheap VPU work that XLA fuses with neighbors.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def _nearest_indices(out_size: int, in_size: int) -> jax.Array:
    # torch nearest: idx = floor(i * in/out) (exact for integer ratios)
    scale = in_size / out_size
    idx = jnp.floor(jnp.arange(out_size, dtype=jnp.float32) * scale).astype(jnp.int32)
    return jnp.clip(idx, 0, in_size - 1)


def resize_nearest(x: jax.Array, size: Tuple[int, int]) -> jax.Array:
    """Nearest-neighbor resize of NHWC ``x`` to (H, W) = ``size``.

    Integer upscales take a broadcast/reshape fast path (floor(i*in/out)
    with out = k*in is exactly k-fold repetition) — this is what the decoder
    hot path uses (exact doubling, decoder.py:114) and it avoids gather
    lowering entirely.
    """
    H_out, W_out = size
    B, H_in, W_in, C = x.shape
    if (H_in, W_in) == (H_out, W_out):
        return x
    if H_out % H_in == 0 and W_out % W_in == 0:
        kh, kw = H_out // H_in, W_out // W_in
        x = jnp.broadcast_to(
            x[:, :, None, :, None, :], (B, H_in, kh, W_in, kw, C)
        )
        return x.reshape(B, H_out, W_out, C)
    rows = _nearest_indices(H_out, H_in)
    cols = _nearest_indices(W_out, W_in)
    return x[:, rows][:, :, cols]


def _linear_weights(out_size: int, in_size: int, align_corners: bool):
    if out_size == 1:
        src = jnp.zeros((1,), jnp.float32)
    elif align_corners:
        src = jnp.arange(out_size, dtype=jnp.float32) * ((in_size - 1) / (out_size - 1))
    else:
        src = (jnp.arange(out_size, dtype=jnp.float32) + 0.5) * (in_size / out_size) - 0.5
        src = jnp.clip(src, 0.0, in_size - 1)
    lo = jnp.floor(src).astype(jnp.int32)
    hi = jnp.minimum(lo + 1, in_size - 1)
    w_hi = src - lo.astype(jnp.float32)
    return lo, hi, w_hi


def _select_rows(xf: jax.Array, idx: jax.Array, in_size: int, axis: int) -> jax.Array:
    """Exact row selection via a one-hot matmul instead of a gather.

    A one-hot selection matmul is work XLA fuses freely, and it is
    BIT-EXACT: each output row accumulates exactly one ``1.0 * x`` term
    plus f32 zeros (finite a + 0.0 == a, and 1.0 * a is exact) — HIGHEST
    precision is requested so no reduced-precision (bf16/TF32) pass
    truncates ``x``.  Whether a plain gather is faster on the GPU is not
    measured yet."""
    onehot = jax.nn.one_hot(idx, in_size, dtype=jnp.float32)
    spec = "oi,biwc->bowc" if axis == 1 else "oi,bhic->bhoc"
    return jnp.einsum(spec, onehot, xf, precision=jax.lax.Precision.HIGHEST)


def _resize_linear(x: jax.Array, size: Tuple[int, int], align_corners: bool) -> jax.Array:
    H_out, W_out = size
    B, H_in, W_in, C = x.shape
    if (H_in, W_in) == (H_out, W_out):
        return x
    dtype = x.dtype
    if (H_in, W_in) == (1, 1):
        # 1x1 source (ASPP global-pool branch, networks.py:25-30): every
        # weight is 0 against the same source pixel — a pure broadcast
        return jnp.broadcast_to(x, (B, H_out, W_out, C))
    xf = x.astype(jnp.float32)

    r_lo, r_hi, r_w = _linear_weights(H_out, H_in, align_corners)
    c_lo, c_hi, c_w = _linear_weights(W_out, W_in, align_corners)

    top = _select_rows(xf, r_lo, H_in, 1)
    bot = _select_rows(xf, r_hi, H_in, 1)
    xf = top + (bot - top) * r_w[None, :, None, None]

    left = _select_rows(xf, c_lo, W_in, 2)
    right = _select_rows(xf, c_hi, W_in, 2)
    xf = left + (right - left) * c_w[None, None, :, None]
    return xf.astype(dtype)


def resize_bilinear_align_corners(x: jax.Array, size: Tuple[int, int]) -> jax.Array:
    """Bilinear resize, torch align_corners=True semantics, NHWC."""
    return _resize_linear(x, size, align_corners=True)


def resize_bilinear(x: jax.Array, size: Tuple[int, int]) -> jax.Array:
    """Bilinear resize, torch align_corners=False (half-pixel) semantics, NHWC."""
    return _resize_linear(x, size, align_corners=False)
