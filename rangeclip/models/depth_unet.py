"""DepthUNet: depth-map -> per-pixel CLIP-space embedding field.

Reference: RangeCLIP/src/depth_segmentation_model/model.py:59-405 —
  * owns the ResNet encoder + UNet decoder (:80-103);
  * learnable log-temperatures, init log(0.07) text / log(0.1) image
    (:77-78);
  * ``forward`` returns (pixel_embeddings, temp_text, temp_image)
    (:108-117);
  * ``predict`` scores pixels against a reduced candidate set (GT labels
    plus sampled negatives) and returns top-k global label indices
    (:119-175).

Static-shape reformulation of ``predict``: instead of materializing a
dynamically-sized reduced embedding table (torch gathers a python-sorted
index list, model.py:147-161), we score against the FULL static [C, D] table
(or a fixed-capacity gathered one) and mask non-candidate classes to -inf
before top-k.  Cross-candidate-set argmax/top-k over a masked score vector
is mathematically identical to top-k over the gathered subset, but keeps
every shape static so the whole path compiles once: one matmul and one
``lax.top_k``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
from rangeclip import nn

from rangeclip.models.decoder import DepthDecoder
from rangeclip.models.encoder import DepthEncoder
from rangeclip.ops.resize import resize_nearest
from rangeclip.utils.math import l2_normalize

NEG_INF = jnp.float32(-1e30)


@dataclasses.dataclass(frozen=True)
class DepthUNetConfig:
    """Canonical hyperparameters (train_util.py:133-144 + launcher)."""

    unet_type: str = "resnet"
    n_layer: int = 18
    input_channels: int = 1
    encoder_filters: Tuple[int, ...] = (32, 64, 128, 256, 512)
    embedding_dim: int = 512
    weight_initializer: str = "kaiming_uniform"
    activation: str = "relu"
    use_batch_norm: bool = True
    use_instance_norm: bool = False
    temperature_text: float = 0.07
    temperature_image: float = 0.1
    dtype: Optional[Any] = None  # compute dtype; None -> fp32
    bn_axis_name: Optional[str] = None
    # Frozen-encoder finetune (model.py:397: the encoder stays in eval mode
    # while training — BN uses running statistics and never updates them;
    # the optimizer side of the freeze is optax-masked zero updates,
    # training/optim.py make_optimizer(freeze_encoder=True)).
    freeze_encoder: bool = False


class DepthUNet(nn.Module):
    config: DepthUNetConfig = DepthUNetConfig()

    def setup(self):
        cfg = self.config
        if cfg.unet_type == "resnet":
            self.depth_encoder = DepthEncoder(
                n_layer=cfg.n_layer,
                n_filters=cfg.encoder_filters,
                embedding_dim=cfg.embedding_dim,
                weight_initializer=cfg.weight_initializer,
                activation=cfg.activation,
                use_batch_norm=cfg.use_batch_norm,
                use_instance_norm=cfg.use_instance_norm,
                bn_axis_name=cfg.bn_axis_name,
                dtype=cfg.dtype,
            )
            decoder_filters = tuple(reversed(cfg.encoder_filters))
        elif cfg.unet_type == "mit":
            # SegFormer-style transformer encoder variant (BASELINE stretch
            # config); same feature-pyramid contract, 4 stages at H/4..H/32.
            from rangeclip.models.mit_encoder import MiTConfig, MiTDepthEncoder

            mit_cfg = MiTConfig(embed_dims=tuple(cfg.encoder_filters[-4:]))
            self.depth_encoder = MiTDepthEncoder(
                config=mit_cfg,
                embedding_dim=cfg.embedding_dim,
                dtype=cfg.dtype,
            )
            decoder_filters = tuple(reversed(mit_cfg.embed_dims))
        else:
            raise ValueError(f"Unsupported depth encoder type: {cfg.unet_type}")
        self.depth_decoder = DepthDecoder(
            n_filters=decoder_filters,
            embedding_dim=cfg.embedding_dim,
            weight_initializer=cfg.weight_initializer,
            activation=cfg.activation,
            use_batch_norm=cfg.use_batch_norm,
            use_instance_norm=cfg.use_instance_norm,
            bn_axis_name=cfg.bn_axis_name,
            dtype=cfg.dtype,
        )
        self.log_temperature_text = self.param(
            "log_temperature_text",
            lambda key: jnp.log(jnp.float32(self.config.temperature_text)),
        )
        self.log_temperature_image = self.param(
            "log_temperature_image",
            lambda key: jnp.log(jnp.float32(self.config.temperature_image)),
        )

    def __call__(
        self, depth: jax.Array, train: bool = False
    ) -> Tuple[jax.Array, jax.Array, jax.Array]:
        """Forward pass.  depth: [B, H, W] or [B, H, W, 1] (NHWC).

        Returns (pixel_embeddings [B, H, W, D], temp_text, temp_image).
        """
        if depth.ndim == 3:
            depth = depth[..., None]
        target_shape = depth.shape[1:3]
        encoder_train = train and not self.config.freeze_encoder
        _, encoder_features, final_feature_map = self.depth_encoder(
            depth, encoder_train
        )
        pixel_embeddings = self.depth_decoder(
            final_feature_map, encoder_features, target_shape, train
        )
        return (
            pixel_embeddings,
            jnp.exp(self.log_temperature_text),
            jnp.exp(self.log_temperature_image),
        )

    def embed(self, depth: jax.Array, train: bool = False) -> jax.Array:
        """Pixel embeddings only (inference helper)."""
        return self(depth, train)[0]

    def forward_native(
        self, depth: jax.Array, train: bool = False
    ) -> Tuple[jax.Array, jax.Array, jax.Array]:
        """Forward pass WITHOUT the final nearest upsample: the normalized
        field at the decoder's native resolution [B, H/2, W/2, D].

        The full-resolution field is exactly the nearest x2 upsample of
        this one (decoder.py:79 + reference decoder.py:113-116), so the
        training losses consume it directly via the upsample identities
        (losses/hybrid.py label_upsample) — same losses/gradients, ~4x
        less memory traffic in the train step.
        """
        if depth.ndim == 3:
            depth = depth[..., None]
        encoder_train = train and not self.config.freeze_encoder
        _, encoder_features, final_feature_map = self.depth_encoder(
            depth, encoder_train
        )
        pixel_embeddings = self.depth_decoder(
            final_feature_map, encoder_features, None, train
        )
        return (
            pixel_embeddings,
            jnp.exp(self.log_temperature_text),
            jnp.exp(self.log_temperature_image),
        )

    def native_field(
        self, depth: jax.Array, normalize: bool = True
    ) -> jax.Array:
        """Native-resolution embedding field [B, H/2, W/2, D], optionally
        skipping the channel L2 normalization (``normalize=False``) for
        consumers that only rank scores (a positive per-pixel scale cannot
        change the top-k order)."""
        if depth.ndim == 3:
            depth = depth[..., None]
        _, encoder_features, final_feature_map = self.depth_encoder(depth, False)
        return self.depth_decoder(
            final_feature_map, encoder_features, None, False,
            normalize=normalize,
        )

    def decode_features(self, depth: jax.Array) -> jax.Array:
        """Pre-head decoder features [B, H/2, W/2, n_filters[-1]] — the
        input to the output conv (decoder.py:75-82), which
        :func:`predict_folded` folds into the scoring."""
        if depth.ndim == 3:
            depth = depth[..., None]
        _, encoder_features, final_feature_map = self.depth_encoder(depth, False)
        return self.depth_decoder(
            final_feature_map, encoder_features, None, False, apply_head=False
        )

    def predict(
        self,
        depth: jax.Array,
        candidate_text_embeddings: jax.Array,
        candidate_mask: jax.Array,
        top_k: int = 5,
        score_native: bool = True,
        return_embeddings: bool = True,
        candidate_indices: Optional[jax.Array] = None,
    ) -> Tuple[jax.Array, jax.Array, jax.Array]:
        """Reduced-candidate top-k prediction (model.py:119-175).

        Args:
          depth: [B, H, W(, 1)] depth maps.
          candidate_text_embeddings: full text table [C, D] (unnormalized).
          candidate_mask: [C] bool — True for classes in the reduced set
            (GT labels + sampled negatives); build it with
            :func:`build_candidate_mask`.  Ignored (may be None) when
            ``candidate_indices`` is given.
          candidate_indices: optional [S] int32, ascending candidate class
            ids padded with -1 (:func:`build_candidate_indices`).  When
            given, scoring GATHERS the S candidate rows of the text table
            first — the reference's own formulation (model.py:147-161) —
            so the matmul and the top-k passes run over S slots instead of
            all C classes (~25% less scoring work at the canonical
            C=512 / 300-negative config).  Because the slots are in
            ascending class order, min-index tie-breaking matches the
            masked path exactly: the two paths return bit-identical labels
            (tested).  S must bound |unique GT labels| + num_negatives.
          top_k: number of top labels per pixel.
          score_native: score at the decoder's native resolution (H/2) and
            nearest-upsample the top-k *indices* to [H, W].  The reference's
            final upsample is nearest (decoder.py:113-116) and normalize /
            scoring / top-k are all per-pixel, so this is EXACTLY the same
            prediction as scoring at full resolution with ~4x fewer scoring
            FLOPs and no [B, H, W, D] field materialization
            (tests/test_model_and_train.py proves the identity).  ``False``
            reproduces the literal full-resolution scoring order.
          return_embeddings: also return the full-resolution L2-normalized
            pixel-embedding field.  ``False`` skips materializing it (the
            serving/bench hot path needs only the labels) and returns the
            L2-normalized native-resolution field instead.  ``"native"`` returns the L2-NORMALIZED field at native
            resolution — what the native-resolution loss path consumes
            (evals/validate.py + hybrid.py label_upsample).

        Returns:
          (topk_pred_indices [B, H, W, k] int32 in the global label space,
           pixel_embeddings L2-normalized — [B, H, W, D] when
           ``return_embeddings`` else the native [B, H/2, W/2, D] field,
           temperature_text scalar).
        """
        if depth.ndim == 3:
            depth = depth[..., None]
        target_shape = depth.shape[1:3]
        _, encoder_features, final_feature_map = self.depth_encoder(depth, False)
        # Normalized once, in the decoder (the reference normalizes in the
        # decoder AND again in predict, decoder.py:116 + model.py:144; at
        # fp32 the re-normalization is a no-op, proven by the fp32 parity
        # tests running this path against torch's double-normalize).
        pixel_embeddings = self.depth_decoder(
            final_feature_map,
            encoder_features,
            None if score_native else target_shape,
            False,
        )
        temp_text = jnp.exp(self.log_temperature_text)

        if candidate_indices is not None:
            # Gathered reduced table (model.py:147-161): one [S, D] gather
            # replaces C-S dead classes in every downstream matmul/top-k.
            table = candidate_text_embeddings[
                jnp.maximum(candidate_indices, 0)
            ]
            candidate_mask = candidate_indices >= 0
        else:
            table = candidate_text_embeddings
        text = l2_normalize(table.astype(jnp.float32), axis=-1)

        B, H, W, D = pixel_embeddings.shape
        logits = jnp.einsum(
            "bhwd,cd->bhwc",
            pixel_embeddings.astype(jnp.float32),
            text,
            preferred_element_type=jnp.float32,
        )
        logits = jnp.where(candidate_mask[None, None, None, :], logits, NEG_INF)
        topk_vals, topk_indices = jax.lax.top_k(logits, top_k)
        if candidate_indices is not None:
            # slot -> global class id
            topk_indices = jnp.take(candidate_indices, topk_indices, axis=0)
        # Exhausted candidate set (fewer candidates than top_k): the
        # remaining picks tie at NEG_INF and would emit arbitrary
        # (possibly duplicate / non-candidate) slots — emit the -1
        # no-candidate sentinel instead, matching predict_folded.  (The
        # reference would crash here: torch.topk(k) over a smaller
        # candidate list.)
        topk_indices = jnp.where(topk_vals > -1e29, topk_indices, -1)

        if (H, W) != target_shape:
            topk_indices = resize_nearest(topk_indices, target_shape)
            if return_embeddings is True:
                pixel_embeddings = resize_nearest(pixel_embeddings, target_shape)
        return topk_indices, pixel_embeddings, temp_text


def predict_folded(
    model: DepthUNet,
    variables,
    depth: jax.Array,
    candidate_text_embeddings: jax.Array,
    candidate_mask: Optional[jax.Array] = None,
    top_k: int = 5,
    candidate_indices: Optional[jax.Array] = None,
    candidate_ids: Optional[jax.Array] = None,
    want_values: bool = False,
    upsample: bool = True,
) -> jax.Array:
    """Labels-only predict with the output conv FOLDED into the scoring.

    The segmentation head is ``topk_c(normalize(conv3x3(x, W)) . t_c)``
    (reference decoder.py:75-82 + model.py:161-169).  Two algebraic facts
    make the [B, h, w, D] embedding field unnecessary when only labels are
    wanted:

      * the conv is bias-free and linear, so the pixel-candidate score
        distributes over it:  conv(x, W) . t_c == conv(x, W @ t_c) — one
        offline contraction ``W' = einsum('hwid,sd->hwis', W, T_norm)``
        turns the conv-to-D plus the [D, S] scoring matmul into a single
        conv straight to the S candidate scores;
      * the per-pixel L2 normalization divides every candidate's score by
        the same positive scalar, so it cannot change the top-k ORDER —
        for labels it is skipped outright.

    Versus the default predict path this never materializes the
    [B, h, w, D] field and cuts the head's matmul FLOPs (9*Cin*S vs
    9*Cin*D + D*S per pixel); it materializes an [B, h, w, S] score field
    instead, which ``lax.top_k`` reads once.

    Exactness: identical ranking in exact arithmetic (proved bit-equal
    under float64 in tests); in finite precision the two paths round
    differently, so labels may differ on near-ties — in bf16 the folded
    path is the BETTER-conditioned one (a single bf16 rounding of W'
    against the default path's bf16 roundings of both the 512-dim field
    and the text table).

    Args beyond `predict`'s: ``candidate_ids`` says the table rows ARE the
    candidate set already — [S] ascending global class ids, -1 for dead
    rows (the class-sharded path, parallel/predict.py, passes each
    device's table slice this way).  ``want_values`` also returns the
    winning scores (f32, un-normalized — comparable across class shards
    but NOT to `predict`'s normalized logits).  ``upsample=False`` skips
    the final nearest-upsample and returns native-resolution indices.

    Returns topk indices [B, H, W, k] i32 in the global label space
    (native [B, h, w, k] when ``upsample=False``); with ``want_values``,
    an ``(indices, values)`` tuple.  A pixel with fewer than ``top_k``
    live candidates gets the -1 sentinel in the missing places.

    When to fold: the folded conv writes an [N, S] score field where the
    default path writes an [N, D] embedding field, so folding trades head
    FLOPs against memory traffic as S grows past D.
    :func:`folded_is_profitable` encodes that crossover; the CLIs'
    ``--predict_path auto`` uses it.
    """
    if depth.ndim == 3:
        depth = depth[..., None]
    target_shape = depth.shape[1:3]
    features = model.apply(variables, depth, method=DepthUNet.decode_features)
    h, w = features.shape[1:3]
    W = variables["params"]["depth_decoder"]["output_conv"]["conv"]["kernel"]

    if candidate_ids is not None:
        table = candidate_text_embeddings
        ids = candidate_ids.astype(jnp.int32)
    elif candidate_indices is not None:
        table = candidate_text_embeddings[jnp.maximum(candidate_indices, 0)]
        ids = candidate_indices.astype(jnp.int32)
    else:
        table = candidate_text_embeddings
        ids = jnp.arange(table.shape[0], dtype=jnp.int32)
        if candidate_mask is not None:
            ids = jnp.where(candidate_mask, ids, -1)
    text = l2_normalize(table.astype(jnp.float32), axis=-1)
    folded = jnp.einsum(
        "hwid,sd->hwis", W.astype(jnp.float32), text,
        preferred_element_type=jnp.float32,
    ).astype(features.dtype)

    scores = jax.lax.conv_general_dilated(
        features, folded, window_strides=(1, 1), padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    masked = jnp.where(ids >= 0, scores.astype(jnp.float32), NEG_INF)
    topk_values, slot = jax.lax.top_k(masked, top_k)
    topk_indices = jnp.take(ids, slot, axis=0)
    # exhausted candidate set -> -1 sentinel (see DepthUNet.predict)
    topk_indices = jnp.where(topk_values > -1e29, topk_indices, -1)

    if upsample and (h, w) != target_shape:
        topk_indices = resize_nearest(topk_indices, target_shape)
        if want_values:
            topk_values = resize_nearest(topk_values, target_shape)
    if want_values:
        return topk_indices, topk_values
    return topk_indices


def folded_is_profitable(num_slots: int, embedding_dim: int = 512) -> bool:
    """Should `predict_folded` be used over `predict` for this candidate
    count?  Folding removes the conv-to-D + scoring matmul (wins FLOPs at
    any S) but materializes an [N, S] score field where the default path
    materializes [N, D] — memory traffic grows with S.  The crossover is
    set at S ~ 1.5*D (slots rounded up to a multiple of 128); re-measuring
    it on the GPU is queued in ROADMAP.md."""
    padded = -(-num_slots // 128) * 128
    return padded <= (3 * embedding_dim) // 2


def build_candidate_mask(
    key: jax.Array,
    segmentation: jax.Array,
    num_classes: int,
    num_negatives: int,
) -> jax.Array:
    """Reduced candidate set as a static boolean mask over all C classes.

    Reference semantics (model.py:147-156): candidates = unique labels in the
    ground-truth segmentation plus ``num_negatives`` labels sampled uniformly
    without replacement from the complement.  Sampling without replacement is
    done with the Gumbel-top-k trick over masked scores; when the complement
    is smaller than ``num_negatives`` every non-GT class is included (the
    reference's ``min(num_negatives, len(pool))``).

    Args:
      key: PRNG key.
      segmentation: [B, H, W] (or any shape) int labels.
      num_classes: C, static.
      num_negatives: static int.

    Returns: [C] bool mask.
    """
    flat = segmentation.reshape(-1)
    gt_mask = jnp.zeros((num_classes,), jnp.bool_).at[flat].set(True)

    gumbel = jax.random.gumbel(key, (num_classes,))
    scores = jnp.where(gt_mask, -jnp.inf, gumbel)
    k = min(num_negatives, num_classes)
    # Keep only finite-score picks (i.e. genuine non-GT classes).
    picked_scores, neg_idx = jax.lax.top_k(scores, k)
    valid = jnp.isfinite(picked_scores)
    neg_mask = jnp.zeros((num_classes,), jnp.bool_).at[neg_idx].max(valid)
    return gt_mask | neg_mask


def candidate_indices_from_mask(
    candidate_mask: jax.Array, capacity: int
) -> jax.Array:
    """[C] bool mask -> [capacity] int32 candidate ids, ascending, -1 pad.

    The ascending order makes min-index tie-breaking over the gathered
    table identical to tie-breaking over the masked full table, so
    ``predict(candidate_indices=...)`` is bit-identical to
    ``predict(candidate_mask=...)`` whenever the mask's population fits in
    ``capacity`` (classes beyond the capacity are silently dropped —
    size it as |unique GT| upper bound + num_negatives).
    """
    C = candidate_mask.shape[0]
    # score True entries by descending class id -> top_k returns the True
    # class ids in ascending order, padded with score-0 (invalid) picks
    score = jnp.where(candidate_mask, C - jnp.arange(C, dtype=jnp.int32), 0)
    val, idx = jax.lax.top_k(score, min(capacity, C))
    idx = jnp.where(val > 0, idx, -1)
    if capacity > C:
        idx = jnp.pad(idx, (0, capacity - C), constant_values=-1)
    return idx


def build_candidate_indices(
    key: jax.Array,
    segmentation: jax.Array,
    num_classes: int,
    num_negatives: int,
    capacity: int,
) -> jax.Array:
    """Reduced candidate set as a fixed-capacity gathered index list.

    Same draw as :func:`build_candidate_mask` (identical key stream), in
    the form the reference actually uses — an index list into the text
    table (model.py:147-161) — emitted ascending and -1-padded to the
    static ``capacity``.  Feed to ``DepthUNet.predict(candidate_indices=)``
    to score S=capacity slots instead of all C classes.
    """
    mask = build_candidate_mask(key, segmentation, num_classes, num_negatives)
    return candidate_indices_from_mask(mask, capacity)
