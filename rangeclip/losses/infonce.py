"""InfoNCE losses with static shapes.

Pixel-text contrastive loss — reference model.py:199-301:
  * sample ``int(0.7*H*W)`` pixel positions per image uniformly WITH
    replacement (torch.randint, model.py:220);
  * drop background pixels (label 0) — here a weight mask instead of a
    dynamic filter (model.py:225-228);
  * build a contrast set: unique sampled GT labels plus k=50 distractors
    split medium/hard/random by the curriculum (model.py:236-268);
  * cross-entropy over normalized pixel x text logits / temperature
    (model.py:289-291).

Static-shape reformulation: the contrast set is a boolean mask over the full
static class axis; CE over the reduced set == CE over full logits with
non-members masked to -inf (identical softmax over the surviving columns).
The distractor draw uses the Gumbel-top-k trick with *dynamic counts as
thresholds* so the curriculum never triggers a recompile.

Area-image contrastive loss — reference model.py:304-326: square InfoNCE
between masked-average-pooled area embeddings and frozen CLIP image
embeddings of the object crops, labels on the diagonal; silently becomes 0
when fewer than 2 valid instances exist (the reference builds a
graph-preserving dummy, model.py:322-326 — unnecessary in JAX where grads of
a 0-weighted term are simply 0).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rangeclip.utils.math import l2_normalize

NEG_INF = jnp.float32(-1e30)


def sample_pixels(
    key: jax.Array,
    pixel_embeddings: jax.Array,
    target: jax.Array,
    percent: float = 0.7,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Uniform with-replacement pixel sampling (model.py:207-228).

    Args:
      pixel_embeddings: [B, H, W, D].
      target: [B, H, W] int labels.
      percent: fraction of H*W to sample (static).

    Returns:
      (samples [B*N, D], labels [B*N], valid [B*N] float32 weight mask with
      0 for background pixels).
    """
    B, H, W, D = pixel_embeddings.shape
    n_total = H * W
    n_samples = max(min(int(percent * n_total), n_total), 1)

    idx = jax.random.randint(key, (B, n_samples), 0, n_total)
    emb_flat = pixel_embeddings.reshape(B, n_total, D)
    tgt_flat = target.reshape(B, n_total)

    samples = jnp.take_along_axis(emb_flat, idx[..., None], axis=1)
    labels = jnp.take_along_axis(tgt_flat, idx, axis=1)
    samples = samples.reshape(B * n_samples, D)
    labels = labels.reshape(B * n_samples)
    valid = (labels > 0).astype(jnp.float32)
    return samples, labels, valid


def sample_pixel_multiplicities(
    key: jax.Array,
    target: jax.Array,
    percent: float = 0.7,
    slots: int = 1,
) -> Tuple[jax.Array, jax.Array]:
    """Multiplicity-weighted reformulation of :func:`sample_pixels`.

    Uniform with-replacement sampling followed by the sample mean is
    identical to weighting EVERY pixel by its sampled multiplicity:
      mean_{i in draws, valid} ce_i  ==  sum_p m_p v_p ce_p / sum_p m_p v_p
    where m ~ histogram of the draws.  This removes the [N, D] row gather
    and its scatter-add adjoint from the train step — the CE reads the
    pixel field in place with per-pixel weights.

    ``slots=s`` emits the histogram directly in the native-resolution slot
    order (hybrid.py label_upsample): the draw indices are remapped
    elementwise to slot-major positions BEFORE the scatter, which is
    bit-identical to transposing the full-res histogram afterwards (same
    draws, same multiset — tested) but never materializes the full-res
    weight layout.

    Returns:
      slots == 1: (weights [B*H*W] f32 = multiplicity * (label > 0),
                   labels [B*H*W] i32);
      slots == s: (weights [s*s, B*h*w], labels [s*s, B*h*w]) with
                  h = H/s, w = W/s, slot (a, c) = full-res pixel
                  (s*i+a, s*j+c) of native pixel (i, j).
    """
    B, H, W = target.shape
    n_total = H * W
    n_samples = max(min(int(percent * n_total), n_total), 1)

    idx = jax.random.randint(key, (B, n_samples), 0, n_total)
    if slots > 1:
        s = slots
        h, w = H // s, W // s
        y, x = idx // W, idx % W
        # full-res (y, x) -> slot-major flat index ((a*s + c)*h + i)*w + j
        idx = ((y % s) * s + (x % s)) * (h * w) + (y // s) * w + (x // s)
    counts = jax.vmap(
        lambda row: jnp.zeros((n_total,), jnp.int32).at[row].add(1)
    )(idx)

    if slots > 1:
        labels = target.reshape(B, h, s, w, s).transpose(2, 4, 0, 1, 3)
        labels = labels.reshape(s * s, B * h * w)
        counts = counts.reshape(B, s * s, h * w).swapaxes(0, 1)
        weights = counts.reshape(s * s, B * h * w).astype(jnp.float32) * (
            labels > 0
        )
        return weights, labels

    labels = target.reshape(B * n_total)
    weights = counts.reshape(B * n_total).astype(jnp.float32) * (labels > 0)
    return weights, labels


def multinomial_counts(key: jax.Array, n: int, n_bins: int,
                       batch: int = 1) -> jax.Array:
    """Exact Multinomial(n, uniform over n_bins) counts WITHOUT a scatter.

    The histogram formulation (:func:`sample_pixel_multiplicities`) is a
    scatter-add.  This generates the same distribution by binary binomial
    splitting: the root holds n balls; at each of ceil(log2(n_bins))
    levels every node splits its count Binomial(count, w_left/w) between
    children, where w counts the real (non-padding) leaves below — so
    non-power-of-two bin counts are exact too.  All splits at one level
    vectorize into a single ``jax.random.binomial`` call.

    Returns [batch, n_bins] float32 counts; each row sums to exactly n.
    """
    levels = max((n_bins - 1).bit_length(), 0)
    padded = 1 << levels
    # real-leaf weight under each node, per level (computed bottom-up)
    leaf = np.zeros((padded,), np.float64)
    leaf[:n_bins] = 1.0
    weights_per_level = []
    w = leaf
    for _ in range(levels):
        w = w.reshape(-1, 2).sum(axis=1)
        weights_per_level.append(w)
    # weights_per_level[-1] is the root; iterate top-down
    counts = jnp.full((batch, 1), float(n), jnp.float32)
    for lev in range(levels - 1, -1, -1):
        w_pair = (weights_per_level[lev - 1].reshape(-1, 2)
                  if lev > 0 else leaf.reshape(-1, 2))
        w_left = jnp.asarray(w_pair[:, 0], jnp.float32)
        w_tot = jnp.asarray(w_pair.sum(axis=1), jnp.float32)
        p = w_left / jnp.maximum(w_tot, 1.0)
        key, sub = jax.random.split(key)
        left = jax.random.binomial(sub, counts, p[None, :])
        counts = jnp.stack([left, counts - left], axis=-1).reshape(batch, -1)
    return counts[:, :n_bins]


def sample_pixel_multiplicities_multinomial(
    key: jax.Array,
    target: jax.Array,
    percent: float = 0.7,
    slots: int = 1,
) -> Tuple[jax.Array, jax.Array]:
    """Scatter-free variant of :func:`sample_pixel_multiplicities` — counts
    drawn directly from the Multinomial law of with-replacement sampling
    (``multinomial_counts``), so the estimator is identical in DISTRIBUTION
    (the reference's torch.randint stream differs from either jax stream
    anyway); the per-key realization differs from the histogram variant.

    ``slots=s`` emits the (label, weight) pairs pre-grouped for
    native-resolution training: bins are assigned slot-major, so no
    full-resolution weight transpose ever materializes.

    Args:
      target: [B, H, W] int labels (H, W divisible by ``slots``).

    Returns:
      slots == 1: (weights [B*H*W] f32, labels [B*H*W] i32) — same contract
        as :func:`sample_pixel_multiplicities`;
      slots == s > 1: (weights [s*s, B*h*w], labels [s*s, B*h*w]) with
        h = H/s, w = W/s — slot (a, c) holds full-res pixel (s*i+a, s*j+c)
        of native pixel (i, j), matching the [B, h, w, D] native field.
    """
    B, H, W = target.shape
    n_total = H * W
    n_samples = max(min(int(percent * n_total), n_total), 1)
    counts = multinomial_counts(key, n_samples, n_total, batch=B)

    if slots == 1:
        labels = target.reshape(B * n_total)
        weights = counts.reshape(B * n_total) * (labels > 0)
        return weights, labels

    s = slots
    h, w = H // s, W // s
    labels = target.reshape(B, h, s, w, s).transpose(2, 4, 0, 1, 3).reshape(
        s * s, B * h * w
    )
    # Bin index within an image IS (slot-major) (a, c, i, j) — multinomial
    # bins are exchangeable, so assigning them slot-major is free.
    weights = counts.reshape(B, s * s, h * w).swapaxes(0, 1).reshape(
        s * s, B * h * w
    ) * (labels > 0)
    return weights, labels


def build_contrast_mask(
    key: jax.Array,
    labels: jax.Array,
    valid: jax.Array,
    num_classes: int,
    medium_matrix: jax.Array,
    hard_matrix: jax.Array,
    k_distractors: int = 50,
    pct_medium: jax.Array | float = 0.0,
    pct_hard: jax.Array | float = 0.75,
) -> jax.Array:
    """Contrast-set membership mask over the class axis (model.py:236-268).

    Pool composition mirrors the reference exactly: the medium and hard
    similarity sets of every label present in the samples are pooled
    together (medium sets included only when n_medium > 0, hard only when
    n_hard > 0), GT labels removed, and n_medium + n_hard distractors drawn
    uniformly without replacement (all of the pool if it is smaller); then
    n_rand = k - n_medium - n_hard further distractors are drawn uniformly
    from the remaining classes.

    Args:
      labels / valid: sampled labels and their weights, any (equal)
        shape — flat [N], or field-shaped [B, h, w] / [S, B, h, w]; the
        value is shape-invariant.
      medium_matrix / hard_matrix: [C, C] bool, row l = similarity set of l
        (see data/labels.py).
      pct_medium / pct_hard: curriculum fractions — may be traced scalars;
        counts become dynamic thresholds, not shapes.

    Returns: [C] bool mask (True = class participates in the softmax).
    """
    C = num_classes
    present = jnp.zeros((C,), jnp.bool_).at[labels].max(valid > 0)
    present_f = present.astype(jnp.float32)

    k = jnp.float32(k_distractors)
    n_medium = jnp.floor(k * jnp.float32(pct_medium)).astype(jnp.int32)
    n_hard = jnp.floor(k * jnp.float32(pct_hard)).astype(jnp.int32)
    n_rand = k_distractors - n_medium - n_hard

    # Union of similarity sets of present labels: row-select via matmul.
    medium_union = (present_f @ medium_matrix.astype(jnp.float32)) > 0
    hard_union = (present_f @ hard_matrix.astype(jnp.float32)) > 0
    pool = ((medium_union & (n_medium > 0)) | (hard_union & (n_hard > 0))) & ~present

    key_mh, key_rand = jax.random.split(key)

    def draw(pool_mask: jax.Array, n: jax.Array, key: jax.Array) -> jax.Array:
        """Uniform sample without replacement: keep pool members whose Gumbel
        score ranks in the top n (dynamic threshold, static shapes)."""
        g = jax.random.gumbel(key, (C,))
        scores = jnp.where(pool_mask, g, -jnp.inf)
        sorted_desc = -jnp.sort(-scores)
        # Threshold = n-th largest score; n == 0 disables the draw entirely.
        thresh_idx = jnp.clip(n - 1, 0, C - 1)
        thresh = sorted_desc[thresh_idx]
        return pool_mask & (scores >= thresh) & (n > 0)

    chosen_mh = draw(pool, n_medium + n_hard, key_mh)
    rand_pool = ~present & ~chosen_mh
    chosen_rand = draw(rand_pool, n_rand, key_rand)

    return present | chosen_mh | chosen_rand


def pixel_text_infonce(
    samples: jax.Array,
    labels: jax.Array,
    valid: jax.Array,
    text_embeddings: jax.Array,
    contrast_mask: jax.Array,
    temperature: jax.Array,
) -> jax.Array:
    """Masked cross-entropy over pixel x text similarities (model.py:271-291).

    Equals CE over the gathered contrast subset: classes outside the mask get
    -inf logits and vanish from the softmax.  Returns 0 when fewer than 2
    contrast classes or no valid samples exist (reference warning paths).

    ``labels``/``valid`` may be flat [N] (one label per sample) or label
    SLOTS [S, N]: sample i contributes sum_s valid[s, i] * CE_i(labels[s, i])
    — the native-resolution training identity where one decoder pixel
    carries the labels of its nearest-upsample children.

    """
    n_contrast = jnp.sum(contrast_mask.astype(jnp.int32))
    n_valid = jnp.sum(valid)
    ok = (n_contrast > 1) & (n_valid > 0)

    if samples.ndim == 4:
        samples = samples.reshape(-1, samples.shape[-1])
    labels2 = labels if labels.ndim == 2 else labels[None]
    valid2 = valid if valid.ndim == 2 else valid[None]

    pred_n = l2_normalize(samples.astype(jnp.float32), axis=-1)
    text_n = l2_normalize(text_embeddings.astype(jnp.float32), axis=-1)
    logits = (
        jnp.einsum("nd,cd->nc", pred_n, text_n, preferred_element_type=jnp.float32)
        / temperature
    )
    logits = jnp.where(contrast_mask[None, :], logits, NEG_INF)

    log_z = jax.nn.logsumexp(logits, axis=-1)
    ce_sum = jnp.float32(0.0)
    for s in range(labels2.shape[0]):
        picked = jnp.take_along_axis(logits, labels2[s][:, None], axis=-1)[:, 0]
        ce_sum = ce_sum + jnp.sum((log_z - picked) * valid2[s])

    loss = ce_sum / jnp.maximum(n_valid, 1.0)
    return jnp.where(ok, loss, 0.0)


def area_image_infonce(
    area_embeddings: jax.Array,
    image_embeddings: jax.Array,
    valid: jax.Array,
    temperature: jax.Array,
) -> jax.Array:
    """Diagonal-label InfoNCE between area and CLIP image embeddings
    (model.py:304-326), with a validity mask over instances.

    Rows/columns of invalid instances are excluded from the softmax; the
    result is identical to running the reference on the packed valid subset.
    Returns 0 when fewer than 2 valid instances.
    """
    area_n = l2_normalize(area_embeddings.astype(jnp.float32), axis=-1)
    img_n = l2_normalize(image_embeddings.astype(jnp.float32), axis=-1)
    logits = (
        jnp.einsum("nd,md->nm", area_n, img_n, preferred_element_type=jnp.float32)
        / temperature
    )
    logits = jnp.where(valid[None, :] > 0, logits, NEG_INF)

    log_z = jax.nn.logsumexp(logits, axis=-1)
    diag = jnp.diagonal(logits)
    ce = log_z - diag

    n_valid = jnp.sum(valid)
    loss = jnp.sum(ce * valid) / jnp.maximum(n_valid, 1.0)
    return jnp.where(n_valid > 1, loss, 0.0)
