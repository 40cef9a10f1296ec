"""Hybrid loss: W_text * L_text + W_image * L_image + W_smooth * L_smooth.

Reference: model.py:178-355 (weights default 1.0 / 0.5 / 2e2,
train_util.py:88-91).  Pure function of (embeddings, batch, tables, rng);
returns the total plus a loss-info dict of scalars mirroring the
reference's ``loss_info`` (model.py:343-353).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from rangeclip.losses.infonce import (
    area_image_infonce,
    build_contrast_mask,
    pixel_text_infonce,
    sample_pixel_multiplicities,
    sample_pixel_multiplicities_multinomial,
    sample_pixels,
)
from rangeclip.losses.smoothness import total_variation_loss


@dataclasses.dataclass(frozen=True)
class HybridLossConfig:
    w_text: float = 1.0
    w_image: float = 0.5
    w_smooth: float = 2e2
    percent_image_sampling: float = 0.7
    k_distractors: int = 50
    # Pixel-draw count generation: "histogram" (== "auto") builds counts
    # from explicit uniform draws — bit-matches gather-sampling for a given
    # key (the parity/proof formulation, a scatter-add).  "multinomial"
    # draws the same Multinomial law scatter-free by binomial splitting
    # (infonce.multinomial_counts); jax.random.binomial's rejection
    # while_loops made it a slow choice inside a large train-step program,
    # so it stays opt-in.
    pixel_sampler: str = "auto"
    # OPT-IN divergence from the reference's uniform pixel sampling
    # (model.py:220): rescale each sampled pixel's CE weight so every
    # PRESENT class contributes equal total weight to the window's
    # pixel-text loss, preserving sum(valid).  Rationale (round-5
    # convergence diagnosis, experiments/convergence_r5/): the synthetic
    # floor plane is >55% of CE targets, diluting the region-class
    # gradient ~10x — the trained model reached 100% floor-pixel top-1 but
    # 10% region-pixel top-1 with precision exonerated (fp32 == bf16 to 3
    # decimals).  Costs one segment-sum + one small-table gather per
    # window; leave False for reference parity.
    class_balanced: bool = False


def pixel_sampling_key(rng: jax.Array) -> jax.Array:
    """The key :func:`compute_hybrid_loss` consumes for pixel sampling —
    use this to precompute ``precomputed_pixels`` outside the loss with a
    bit-identical stream (the loss splits ``rng`` into (pixel, contrast)
    keys and this returns the first)."""
    return jax.random.split(rng)[0]


def compute_hybrid_loss(
    rng: jax.Array,
    pixel_embeddings: jax.Array,
    target_indices: jax.Array,
    candidate_text_embeddings: jax.Array,
    medium_matrix: jax.Array,
    hard_matrix: jax.Array,
    temperature_text: jax.Array,
    temperature_image: jax.Array,
    pct_medium: jax.Array | float,
    pct_hard: jax.Array | float,
    area_embeddings: Optional[jax.Array] = None,
    image_embeddings: Optional[jax.Array] = None,
    area_valid: Optional[jax.Array] = None,
    sample_weight: Optional[jax.Array] = None,
    config: HybridLossConfig = HybridLossConfig(),
    label_upsample: int = 1,
    precomputed_pixels: Optional[Tuple[jax.Array, jax.Array]] = None,
) -> Tuple[jax.Array, Dict[str, jax.Array]]:
    """Full hybrid loss (model.py:178-355).

    Args:
      rng: key consumed for pixel sampling + distractor draws.
      precomputed_pixels: optional (weights, labels) from one of the
        multiplicity samplers, computed OUTSIDE this call with the key
        :func:`pixel_sampling_key` derives from ``rng`` — bit-identical to
        in-loss sampling.  The train step hoists the multinomial sampler
        this way: ``jax.random.binomial``'s rejection while_loops run
        badly when traced inside scan+grad, but sampling needs no
        gradient, so outside the grad they run once.
      pixel_embeddings: [B, H, W, D] decoder output (already L2-normalized).
      target_indices: [B, H, W] int segmentation labels.
      label_upsample: s >= 1 — the NATIVE-RESOLUTION training mode.  The
        model's full-resolution field is a nearest xs upsample of the
        decoder's native output (decoder.py:79); every loss term commutes
        with that upsample exactly, so pass the native field
        [B, H/s, W/s, D] with full-res labels [B, H, W] and s here:
          * pixel-text CE: each native pixel carries its s^2 children's
            (label, weight) pairs as label slots (infonce.py);
          * TV: native differences with per-direction pair-count scaling
            (smoothness.py);
        identical losses and gradients, ~4x less memory traffic.  The caller
        pools areas with the same identity
        (per_item_masked_pooling(..., upsample=s)).
      candidate_text_embeddings: [C, D] frozen CLIP text table (unnormalized).
      medium_matrix / hard_matrix: [C, C] bool similarity sets.
      pct_medium / pct_hard: curriculum fractions (traced scalars OK).
      area_embeddings / image_embeddings / area_valid: [B, D], [B, D], [B]
        for the area-image pathway; pass None to disable (W_image term -> 0,
        matching the reference's dummy-loss branch, model.py:322-326).
      sample_weight: optional [B] float mask — 0 drops a batch item from the
        pixel-text loss (used for fixed-shape padded final batches).
    """
    cfg = config
    num_classes = candidate_text_embeddings.shape[0]
    s = label_upsample
    if s > 1:
        B_, h_, w_ = (pixel_embeddings.shape[0], pixel_embeddings.shape[1],
                      pixel_embeddings.shape[2])
        assert target_indices.shape == (B_, h_ * s, w_ * s), (
            f"native field {pixel_embeddings.shape} x{s} vs labels "
            f"{target_indices.shape}"
        )

    text_loss = jnp.float32(0.0)
    if cfg.w_text > 0:
        key_pix, key_contrast = jax.random.split(rng)
        if precomputed_pixels is not None:
            valid, labels = precomputed_pixels
            samples = pixel_embeddings
        elif cfg.pixel_sampler == "multinomial":
            # Scatter-free Multinomial counts, emitted pre-slotted for the
            # native mode (see HybridLossConfig.pixel_sampler — opt-in).
            valid, labels = sample_pixel_multiplicities_multinomial(
                key_pix, target_indices, cfg.percent_image_sampling, slots=s
            )
            samples = pixel_embeddings
        elif s > 1:
            # Multiplicity-weighted reformulation: identical estimator, no
            # row gather / scatter-add adjoint (see infonce.py).  The flat
            # histogram is regrouped into label slots below (bit-matches
            # the full-res formulation for the equivalence tests).
            valid, labels = sample_pixel_multiplicities(
                key_pix, target_indices, cfg.percent_image_sampling,
            )
            samples = pixel_embeddings
        else:
            samples, labels, valid = sample_pixels(
                key_pix, pixel_embeddings, target_indices,
                cfg.percent_image_sampling,
            )
        if sample_weight is not None:
            B = pixel_embeddings.shape[0]
            sw = sample_weight.astype(jnp.float32)
            if valid.ndim == 2:  # [S, B*h*w] slot layout
                S, N = valid.shape
                valid = (valid.reshape(S, B, N // B) * sw[None, :, None]
                         ).reshape(S, N)
            else:
                n_per_item = valid.shape[0] // B
                valid = valid * jnp.repeat(sw, n_per_item)
        contrast_mask = build_contrast_mask(
            key_contrast,
            labels.reshape(-1),
            valid.reshape(-1),
            num_classes,
            medium_matrix,
            hard_matrix,
            cfg.k_distractors,
            pct_medium,
            pct_hard,
        )
        if s > 1 and labels.ndim == 1:
            # Slot the s^2 full-res children of each native pixel: flat
            # full-res index ((b*H + (s*i+a))*W + (s*j+c)) regroups to slot
            # (a, c) of native flat index ((b*h + i)*w + j).
            labels = labels.reshape(B_, h_, s, w_, s).transpose(
                2, 4, 0, 1, 3).reshape(s * s, B_ * h_ * w_)
            valid = valid.reshape(B_, h_, s, w_, s).transpose(
                2, 4, 0, 1, 3).reshape(s * s, B_ * h_ * w_)
        if cfg.class_balanced:
            flat_l = labels.reshape(-1)
            flat_v = valid.reshape(-1).astype(jnp.float32)
            counts = jax.ops.segment_sum(flat_v, flat_l,
                                         num_segments=num_classes)
            present = counts > 0
            n_present = jnp.maximum(jnp.sum(present.astype(jnp.float32)),
                                    1.0)
            mult = jnp.where(present,
                             jnp.sum(counts) / (n_present
                                                * jnp.maximum(counts, 1e-9)),
                             0.0)
            valid = (flat_v * jnp.take(mult, flat_l)).reshape(valid.shape)
        text_loss = pixel_text_infonce(
            samples, labels, valid, candidate_text_embeddings, contrast_mask,
            temperature_text,
        )

    image_loss = jnp.float32(0.0)
    if (
        cfg.w_image > 0
        and area_embeddings is not None
        and image_embeddings is not None
    ):
        if area_valid is None:
            area_valid = jnp.ones((area_embeddings.shape[0],), jnp.float32)
        image_loss = area_image_infonce(
            area_embeddings, image_embeddings, area_valid, temperature_image
        )

    smooth_loss = jnp.float32(0.0)
    if cfg.w_smooth > 0:
        smooth_loss = total_variation_loss(
            pixel_embeddings, upsample=s, sample_weight=sample_weight
        )

    total = cfg.w_text * text_loss + cfg.w_image * image_loss + cfg.w_smooth * smooth_loss

    loss_info = {
        "total_loss": total,
        "text_contrastive_loss": text_loss,
        "image_contrastive_loss": image_loss,
        "smoothness_loss": smooth_loss,
        "temperature_text": temperature_text,
        "temperature_image": temperature_image,
        "W_text": jnp.float32(cfg.w_text),
        "W_image": jnp.float32(cfg.w_image),
        "W_smooth": jnp.float32(cfg.w_smooth),
    }
    return total, loss_info
