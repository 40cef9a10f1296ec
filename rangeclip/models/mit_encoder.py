"""SegFormer-style hierarchical transformer depth encoder (MiT).

The ViT-backbone variant named in BASELINE.json's stretch configs: a
Mix-Transformer encoder for 1-channel depth maps producing the same
4-scale feature pyramid contract as the ResNet encoder, so the UNet decoder
and the whole contrastive stack reuse it unchanged (``unet_type='mit'``).

Architecture (SegFormer MiT family):
  * overlapped patch embedding per stage (stride-4 7x7, then stride-2 3x3);
  * efficient self-attention with per-stage spatial-reduction ratios —
    K/V are downsampled by a strided conv before attention, so the
    [N, N/R^2] attention matrices stay small at 512^2 inputs;
  * Mix-FFN (dense -> 3x3 depthwise conv -> GELU -> dense) instead of
    positional encodings;
  * LayerNorm after each stage.

Attention is batched einsum over static shapes; at 512x512 the
stage-1 sequence is 16384 tokens with R=8 reducing K/V to 256 — a [16384,
256] score matrix that tiles cleanly.  All shapes static; no masking needed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import jax
import jax.numpy as jnp
from rangeclip import nn

from rangeclip.ops.aspp import ASPP
from rangeclip.utils.math import l2_normalize


@dataclasses.dataclass(frozen=True)
class MiTConfig:
    embed_dims: Tuple[int, ...] = (32, 64, 160, 256)  # MiT-B0
    depths: Tuple[int, ...] = (2, 2, 2, 2)
    num_heads: Tuple[int, ...] = (1, 2, 5, 8)
    sr_ratios: Tuple[int, ...] = (8, 4, 2, 1)
    mlp_ratio: int = 4
    layer_norm_eps: float = 1e-6


def _fit_heads(dim: int, heads: int) -> int:
    """Largest head count <= ``heads`` that divides ``dim`` (non-canonical
    stage widths, e.g. in tests, would otherwise break the head split)."""
    h = min(heads, dim)
    while dim % h != 0:
        h -= 1
    return h


class OverlapPatchEmbed(nn.Module):
    dim: int
    patch_size: int
    stride: int
    dtype: Optional[Any] = None

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        p = self.patch_size // 2
        x = nn.Conv(self.dim, (self.patch_size, self.patch_size),
                    strides=(self.stride, self.stride),
                    padding=[(p, p), (p, p)], dtype=self.dtype, name="proj")(x)
        return nn.LayerNorm(epsilon=1e-6, dtype=self.dtype, name="norm")(x)


class EfficientAttention(nn.Module):
    dim: int
    heads: int
    sr_ratio: int
    dtype: Optional[Any] = None

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        B, H, W, C = x.shape
        Dh = self.dim // self.heads
        q = nn.Dense(self.dim, dtype=self.dtype, name="q")(x)
        q = q.reshape(B, H * W, self.heads, Dh)

        kv_in = x
        if self.sr_ratio > 1:
            r = self.sr_ratio
            kv_in = nn.Conv(self.dim, (r, r), strides=(r, r), dtype=self.dtype,
                            name="sr")(x)
            kv_in = nn.LayerNorm(epsilon=1e-6, dtype=self.dtype, name="sr_norm")(kv_in)
        Hk, Wk = kv_in.shape[1:3]
        k = nn.Dense(self.dim, dtype=self.dtype, name="k")(kv_in)
        v = nn.Dense(self.dim, dtype=self.dtype, name="v")(kv_in)
        k = k.reshape(B, Hk * Wk, self.heads, Dh)
        v = v.reshape(B, Hk * Wk, self.heads, Dh)

        scores = jnp.einsum("bqhd,bkhd->bhqk", q, k,
                            preferred_element_type=jnp.float32)
        scores = scores / jnp.sqrt(jnp.float32(Dh))
        probs = jax.nn.softmax(scores, axis=-1).astype(v.dtype)
        out = jnp.einsum("bhqk,bkhd->bqhd", probs, v,
                         preferred_element_type=jnp.float32)
        out = out.reshape(B, H, W, self.dim).astype(x.dtype)
        return nn.Dense(self.dim, dtype=self.dtype, name="proj")(out)


class MixFFN(nn.Module):
    dim: int
    mlp_ratio: int
    dtype: Optional[Any] = None

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        hidden = self.dim * self.mlp_ratio
        h = nn.Dense(hidden, dtype=self.dtype, name="fc1")(x)
        h = nn.Conv(hidden, (3, 3), padding="SAME", feature_group_count=hidden,
                    dtype=self.dtype, name="dwconv")(h)
        h = jax.nn.gelu(h)
        return nn.Dense(self.dim, dtype=self.dtype, name="fc2")(h)


class MiTBlock(nn.Module):
    dim: int
    heads: int
    sr_ratio: int
    mlp_ratio: int
    dtype: Optional[Any] = None

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        h = nn.LayerNorm(epsilon=1e-6, dtype=self.dtype, name="norm1")(x)
        x = x + EfficientAttention(self.dim, self.heads, self.sr_ratio,
                                   self.dtype, name="attn")(h)
        h = nn.LayerNorm(epsilon=1e-6, dtype=self.dtype, name="norm2")(x)
        return x + MixFFN(self.dim, self.mlp_ratio, self.dtype, name="ffn")(h)


class MiTDepthEncoder(nn.Module):
    """4-stage MiT encoder with the DepthEncoder return contract:
    (global_embedding, stage_features, aspp_feature_map)."""

    config: MiTConfig = MiTConfig()
    embedding_dim: int = 512
    dtype: Optional[Any] = None

    @nn.compact
    def __call__(
        self, x: jax.Array, train: bool = False
    ) -> Tuple[jax.Array, List[jax.Array], jax.Array]:
        if x.ndim == 3:
            x = x[..., None]
        cfg = self.config
        features: List[jax.Array] = []

        for stage in range(4):
            patch, stride = (7, 4) if stage == 0 else (3, 2)
            x = OverlapPatchEmbed(cfg.embed_dims[stage], patch, stride,
                                  self.dtype, name=f"patch_embed{stage}")(x)
            heads = _fit_heads(cfg.embed_dims[stage], cfg.num_heads[stage])
            for i in range(cfg.depths[stage]):
                x = MiTBlock(
                    cfg.embed_dims[stage], heads,
                    cfg.sr_ratios[stage], cfg.mlp_ratio, self.dtype,
                    name=f"stage{stage}_block{i}",
                )(x)
            x = nn.LayerNorm(epsilon=1e-6, dtype=self.dtype,
                             name=f"stage{stage}_norm")(x)
            features.append(x)

        pooled = jnp.mean(x, axis=(1, 2))
        h = nn.Dense(cfg.embed_dims[-1], dtype=self.dtype,
                     name="projection_head_fc1")(pooled)
        h = jax.nn.relu(h)
        h = nn.Dense(self.embedding_dim, dtype=self.dtype,
                     name="projection_head_fc2")(h)
        embedding = l2_normalize(h, axis=-1)

        aspp_map = ASPP(features=self.embedding_dim, dtype=self.dtype,
                        name="aspp")(x)
        return embedding, features, aspp_map
