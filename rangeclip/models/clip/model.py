"""CLIP text + vision towers (ViT-B/32 by default).

From-scratch implementation of the architecture consumed by the reference
through HF transformers (train_util.py:125-131).  Matches HF's
``CLIPModel.get_text_features`` / ``get_image_features`` numerics given
converted weights (see convert.py):

  Text tower: token + position embeddings -> 12 pre-LN transformer layers
  (quick_gelu MLP, causal mask) -> final LN -> feature at the EOT position
  (highest token id) -> 512x512 projection without bias.

  Vision tower: 32x32 patch conv (no bias) + class token + position
  embeddings -> pre-LN -> 12 transformer layers (no mask) -> LN on the class
  token -> 768x512 projection without bias.

Attention is computed as one batched einsum per projection;
sequence lengths are tiny (77 / 50) so no flash-attention machinery is
warranted; the whole tower jits into a single program that the trainer
caches and reuses for the frozen-embedding precompute.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp
from rangeclip import nn


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    vocab_size: int = 49408
    max_position_embeddings: int = 77
    text_width: int = 512
    text_heads: int = 8
    text_layers: int = 12
    image_size: int = 224
    patch_size: int = 32
    vision_width: int = 768
    vision_heads: int = 12
    vision_layers: int = 12
    projection_dim: int = 512
    layer_norm_eps: float = 1e-5
    dtype: Optional[Any] = None


CLIP_VIT_B32 = CLIPConfig()


def quick_gelu(x: jax.Array) -> jax.Array:
    return x * jax.nn.sigmoid(1.702 * x)


class MultiHeadAttention(nn.Module):
    width: int
    heads: int
    dtype: Optional[Any] = None

    @nn.compact
    def __call__(self, x: jax.Array, mask: Optional[jax.Array] = None) -> jax.Array:
        B, L, W = x.shape
        H = self.heads
        Dh = W // H

        def proj(name):
            return nn.Dense(W, dtype=self.dtype, name=name)

        q = proj("q_proj")(x).reshape(B, L, H, Dh)
        k = proj("k_proj")(x).reshape(B, L, H, Dh)
        v = proj("v_proj")(x).reshape(B, L, H, Dh)

        scores = jnp.einsum("bqhd,bkhd->bhqk", q, k,
                            preferred_element_type=jnp.float32)
        scores = scores / jnp.sqrt(jnp.float32(Dh))
        if mask is not None:
            scores = scores + mask
        probs = jax.nn.softmax(scores, axis=-1).astype(v.dtype)
        out = jnp.einsum("bhqk,bkhd->bqhd", probs, v,
                         preferred_element_type=jnp.float32)
        out = out.reshape(B, L, W).astype(x.dtype)
        return proj("out_proj")(out)


class TransformerLayer(nn.Module):
    width: int
    heads: int
    eps: float = 1e-5
    dtype: Optional[Any] = None

    @nn.compact
    def __call__(self, x: jax.Array, mask: Optional[jax.Array] = None) -> jax.Array:
        h = nn.LayerNorm(epsilon=self.eps, dtype=self.dtype, name="layer_norm1")(x)
        x = x + MultiHeadAttention(self.width, self.heads, self.dtype, name="attn")(h, mask)
        h = nn.LayerNorm(epsilon=self.eps, dtype=self.dtype, name="layer_norm2")(x)
        h = nn.Dense(4 * self.width, dtype=self.dtype, name="fc1")(h)
        h = quick_gelu(h)
        h = nn.Dense(self.width, dtype=self.dtype, name="fc2")(h)
        return x + h


class CLIPTextTower(nn.Module):
    config: CLIPConfig = CLIP_VIT_B32

    @nn.compact
    def __call__(self, input_ids: jax.Array) -> jax.Array:
        """input_ids: [B, L] int32 -> text features [B, projection_dim]."""
        cfg = self.config
        B, L = input_ids.shape

        tok = nn.Embed(cfg.vocab_size, cfg.text_width, dtype=cfg.dtype,
                       name="token_embedding")(input_ids)
        pos = self.param(
            "position_embedding",
            nn.initializers.normal(0.01),
            (cfg.max_position_embeddings, cfg.text_width),
        )
        x = tok + pos[None, :L, :]

        causal = jnp.triu(jnp.full((L, L), -1e9, jnp.float32), k=1)[None, None]
        for i in range(cfg.text_layers):
            x = TransformerLayer(cfg.text_width, cfg.text_heads, cfg.layer_norm_eps,
                                 cfg.dtype, name=f"layer{i}")(x, causal)
        x = nn.LayerNorm(epsilon=cfg.layer_norm_eps, dtype=cfg.dtype,
                         name="final_layer_norm")(x)

        # Feature = hidden state at the EOT token (highest id in CLIP's vocab)
        eot = jnp.argmax(input_ids, axis=-1)
        pooled = x[jnp.arange(B), eot]
        return nn.Dense(cfg.projection_dim, use_bias=False, dtype=cfg.dtype,
                        name="text_projection")(pooled)


class CLIPVisionTower(nn.Module):
    config: CLIPConfig = CLIP_VIT_B32

    @nn.compact
    def __call__(
        self, pixel_values: jax.Array, return_patches: bool = False
    ) -> jax.Array:
        """pixel_values: [B, H, W, 3] (CLIP-normalized, NHWC) ->
        image features [B, projection_dim].

        With ``return_patches=True`` returns per-patch projected features
        [B, gh, gw, projection_dim] instead (MaskCLIP-style dense probe —
        the reference's evaluate_mask_clip, evaluation.py:162-237, projects
        patch tokens through visual_projection)."""
        cfg = self.config
        B = pixel_values.shape[0]

        x = nn.Conv(
            cfg.vision_width,
            kernel_size=(cfg.patch_size, cfg.patch_size),
            strides=(cfg.patch_size, cfg.patch_size),
            use_bias=False,
            dtype=cfg.dtype,
            name="patch_embedding",
        )(pixel_values)
        x = x.reshape(B, -1, cfg.vision_width)  # [B, n_patches, W]

        cls = self.param("class_embedding", nn.initializers.normal(0.02),
                         (cfg.vision_width,))
        x = jnp.concatenate([jnp.tile(cls[None, None], (B, 1, 1)), x], axis=1)

        n_pos = x.shape[1]
        pos = self.param("position_embedding", nn.initializers.normal(0.02),
                         (n_pos, cfg.vision_width))
        x = x + pos[None]

        x = nn.LayerNorm(epsilon=cfg.layer_norm_eps, dtype=cfg.dtype,
                         name="pre_layernorm")(x)
        for i in range(cfg.vision_layers):
            x = TransformerLayer(cfg.vision_width, cfg.vision_heads,
                                 cfg.layer_norm_eps, cfg.dtype, name=f"layer{i}")(x)
        post_ln = nn.LayerNorm(epsilon=cfg.layer_norm_eps, dtype=cfg.dtype,
                               name="post_layernorm")
        projection = nn.Dense(cfg.projection_dim, use_bias=False, dtype=cfg.dtype,
                              name="visual_projection")
        if return_patches:
            grid = pixel_values.shape[1] // cfg.patch_size, pixel_values.shape[2] // cfg.patch_size
            patches = projection(post_ln(x[:, 1:]))
            return patches.reshape(B, grid[0], grid[1], cfg.projection_dim)
        return projection(post_ln(x[:, 0]))
