"""The XLA formulations of the head, losses and reductions against numpy
oracles: the contracts every later GPU kernel has to keep.

Covered: the exhausted-candidate ``-1`` sentinel, top-k tie order (lowest
class id first), ``predict_folded`` == ``predict`` in every candidate
form, 4-D vs flat and slotted pixel-text CE, masked contrast vs the
gathered member table, label slots, class presence and the multiplicity
histogram, masked pooling, and TV / L2-normalize values and gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rangeclip.losses.infonce import (
    build_contrast_mask,
    pixel_text_infonce,
    sample_pixel_multiplicities,
)
from rangeclip.losses.pooling import (
    masked_average_pooling,
    per_item_masked_pooling,
)
from rangeclip.losses.smoothness import total_variation_loss
from rangeclip.models.depth_unet import (
    DepthUNet,
    DepthUNetConfig,
    candidate_indices_from_mask,
    predict_folded,
)
from rangeclip.utils.math import l2_normalize

B, R, D = 2, 16, 32
CFG = DepthUNetConfig(encoder_filters=(8, 16, 16, 16, 32), embedding_dim=D,
                      use_batch_norm=True)


@pytest.fixture(scope="module")
def unet():
    model = DepthUNet(CFG)
    depth = jax.random.normal(jax.random.key(0), (B, R, R, 1))
    variables = model.init(jax.random.key(1), depth, train=False)
    field = np.asarray(model.apply(variables, depth,
                                   method=DepthUNet.native_field))
    return model, variables, depth, field


def _oracle_topk(field, table, ids, k):
    """numpy: per native pixel, candidates by descending cosine score,
    ties to the lowest class id, -1 once the live candidates run out."""
    t = table / np.linalg.norm(table, axis=-1, keepdims=True)
    scores = field.astype(np.float64) @ t.T.astype(np.float64)
    out = np.full(field.shape[:-1] + (k,), -1, np.int64)
    live = np.nonzero(ids >= 0)[0]
    for idx in np.ndindex(*field.shape[:-1]):
        order = sorted(live, key=lambda s: (-scores[idx + (s,)], ids[s]))
        for j, s in enumerate(order[:k]):
            out[idx + (j,)] = ids[s]
    return np.repeat(np.repeat(out, 2, axis=1), 2, axis=2)


@pytest.mark.parametrize("path", ["predict", "folded"])
def test_exhausted_candidates_emit_minus_one(unet, path):
    model, variables, depth, field = unet
    C, k = 10, 5
    text = jax.random.normal(jax.random.key(2), (C, D))
    mask = jnp.zeros((C,), bool).at[jnp.array([2, 7])].set(True)
    if path == "predict":
        got = model.apply(variables, depth, text, mask, k,
                          method=DepthUNet.predict)[0]
    else:
        got = predict_folded(model, variables, depth, text,
                             candidate_mask=mask, top_k=k)
    got = np.asarray(got)
    assert set(np.unique(got[..., :2])) <= {2, 7}
    assert (got[..., 2:] == -1).all()
    np.testing.assert_array_equal(
        got, _oracle_topk(field, np.asarray(text), np.where(mask, np.arange(C),
                                                            -1), k))


@pytest.mark.parametrize("path", ["predict", "folded"])
def test_topk_ties_resolve_to_lowest_class_id(unet, path):
    model, variables, depth, _ = unet
    base = jax.random.normal(jax.random.key(3), (3, D))
    # classes 1, 4 and 6 are the same direction: every pixel ties them
    text = jnp.stack([base[0], base[1], base[2], -base[0], base[1],
                      -base[2], base[1]])
    mask = jnp.ones((7,), bool)
    if path == "predict":
        got = model.apply(variables, depth, text, mask, 7,
                          method=DepthUNet.predict)[0]
    else:
        got = predict_folded(model, variables, depth, text, top_k=7)
    got = np.asarray(got)
    pos = {c: np.argmax(got == c, axis=-1) for c in (1, 4, 6)}
    assert ((pos[1] < pos[4]) & (pos[4] < pos[6])).all()
    assert (np.abs(pos[4] - pos[1]) == 1).all()


@pytest.mark.parametrize("form", ["mask", "indices", "ids"])
def test_predict_folded_equals_predict_and_oracle(unet, form):
    model, variables, depth, field = unet
    C, k = 12, 3
    text = jax.random.normal(jax.random.key(4), (C, D))
    mask = jnp.arange(C) % 3 != 1
    want = np.asarray(model.apply(variables, depth, text, mask, k,
                                  method=DepthUNet.predict)[0])
    if form == "mask":
        got = predict_folded(model, variables, depth, text,
                             candidate_mask=mask, top_k=k)
    elif form == "indices":
        got = predict_folded(
            model, variables, depth, text, top_k=k,
            candidate_indices=candidate_indices_from_mask(mask, 16))
    else:
        ids = jnp.where(mask, jnp.arange(C), -1)
        got = predict_folded(model, variables, depth, text,
                             candidate_ids=ids, top_k=k)
    np.testing.assert_array_equal(np.asarray(got), want)
    oracle = _oracle_topk(field, np.asarray(text),
                          np.where(np.asarray(mask), np.arange(C), -1), k)
    assert np.mean(want == oracle) > 0.999


def _np_ce(samples, labels, valid, text, mask, temp):
    """numpy masked CE; labels/valid are [S, N] slots."""
    x = samples / np.linalg.norm(samples, axis=-1, keepdims=True)
    t = text / np.linalg.norm(text, axis=-1, keepdims=True)
    logits = (x @ t.T) / temp
    logits = np.where(mask[None], logits, -1e30)
    lse = np.log(np.sum(np.exp(logits - logits.max(-1, keepdims=True)),
                        -1)) + logits.max(-1)
    ce = 0.0
    for s in range(labels.shape[0]):
        picked = logits[np.arange(len(x)), labels[s]]
        ce += np.sum((lse - picked) * valid[s])
    return ce / max(valid.sum(), 1.0)


def _ce_inputs(seed=5, C=16):
    rng = np.random.default_rng(seed)
    field = rng.standard_normal((B, 4, 4, D)).astype(np.float32)
    labels = rng.integers(0, C, (4, B * 16)).astype(np.int32)
    valid = (rng.random((4, B * 16)) < 0.7).astype(np.float32) * (labels > 0)
    text = rng.standard_normal((C, D)).astype(np.float32)
    mask = np.zeros(C, bool)
    mask[np.unique(labels[valid > 0])] = True
    mask[[3, 9]] = True
    return field, labels, valid, text, mask


@pytest.mark.parametrize("layout", ["4d_slots", "flat_slots", "flat_single"])
def test_pixel_text_ce_layouts_match_numpy(layout):
    field, labels, valid, text, mask = _ce_inputs()
    temp = 0.07
    if layout == "flat_single":
        labels, valid = labels[:1], valid[:1]
    samples = field if layout == "4d_slots" else field.reshape(-1, D)
    lab = labels[0] if layout == "flat_single" else labels
    val = valid[0] if layout == "flat_single" else valid
    got = pixel_text_infonce(jnp.asarray(samples), jnp.asarray(lab),
                             jnp.asarray(val), jnp.asarray(text),
                             jnp.asarray(mask), jnp.float32(temp))
    want = _np_ce(field.reshape(-1, D), labels, valid, text, mask, temp)
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_masked_contrast_equals_gathered_member_table():
    """CE over all C classes with non-members masked == CE over the table
    of members only (the reference's gathered contrast set)."""
    field, labels, valid, text, mask = _ce_inputs(seed=6)
    members = np.nonzero(mask)[0]
    remap = np.full(len(mask), -1)
    remap[members] = np.arange(len(members))
    packed = _np_ce(field.reshape(-1, D), np.where(valid > 0, remap[labels], 0),
                    valid, text[members], np.ones(len(members), bool), 0.1)
    got = pixel_text_infonce(jnp.asarray(field), jnp.asarray(labels),
                             jnp.asarray(valid), jnp.asarray(text),
                             jnp.asarray(mask), jnp.float32(0.1))
    np.testing.assert_allclose(float(got), packed, rtol=1e-5)


def test_label_slots_regroup_full_resolution_pixels():
    """slots=s multiplicities == the full-res histogram regrouped so slot
    (a, c) of native pixel (i, j) is full-res pixel (s*i+a, s*j+c)."""
    s, H = 2, 8
    seg = jax.random.randint(jax.random.key(7), (B, H, H), 0, 5)
    key = jax.random.key(8)
    w_flat, l_flat = sample_pixel_multiplicities(key, seg, 0.7)
    w_slot, l_slot = sample_pixel_multiplicities(key, seg, 0.7, slots=s)
    h = H // s

    def regroup(x):
        return np.asarray(x).reshape(B, h, s, h, s).transpose(
            2, 4, 0, 1, 3).reshape(s * s, B * h * h)

    np.testing.assert_array_equal(np.asarray(w_slot), regroup(w_flat))
    np.testing.assert_array_equal(np.asarray(l_slot), regroup(l_flat))


def test_multiplicity_histogram_matches_bincount():
    H = 8
    seg = jax.random.randint(jax.random.key(9), (B, H, H), 0, 4)
    key = jax.random.key(10)
    weights, labels = sample_pixel_multiplicities(key, seg, 0.5)
    n = int(0.5 * H * H)
    draws = np.asarray(jax.random.randint(key, (B, n), 0, H * H))
    counts = np.stack([np.bincount(r, minlength=H * H) for r in draws])
    want = counts.reshape(-1) * (np.asarray(seg).reshape(-1) > 0)
    np.testing.assert_array_equal(np.asarray(weights), want)
    np.testing.assert_array_equal(np.asarray(labels),
                                  np.asarray(seg).reshape(-1))


def test_contrast_mask_presence_and_distractor_count():
    C = 30
    rng = np.random.default_rng(11)
    labels = rng.integers(0, 8, 200).astype(np.int32)
    valid = (rng.random(200) < 0.5).astype(np.float32)
    med = rng.random((C, C)) < 0.1
    hard = rng.random((C, C)) < 0.1
    mask = np.asarray(build_contrast_mask(
        jax.random.key(12), jnp.asarray(labels), jnp.asarray(valid), C,
        jnp.asarray(med), jnp.asarray(hard), 10, 0.2, 0.5))
    present = np.zeros(C, bool)
    present[labels[valid > 0]] = True
    assert (mask[present]).all()
    assert mask.sum() == present.sum() + 10


def test_masked_average_pooling_matches_numpy():
    rng = np.random.default_rng(13)
    emb = rng.standard_normal((B, 6, 6, D)).astype(np.float32)
    seg = rng.integers(0, 4, (B, 6, 6)).astype(np.int32)
    obj = np.array([0, 2, 3, 7], np.int32)
    got = np.asarray(masked_average_pooling(jnp.asarray(emb),
                                            jnp.asarray(seg),
                                            jnp.asarray(obj)))
    for i, o in enumerate(obj):
        sel = emb[seg == o]
        want = sel.mean(0) if len(sel) else np.zeros(D)
        np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("upsample", [1, 2])
def test_per_item_pooling_matches_numpy(upsample):
    rng = np.random.default_rng(14)
    emb = rng.standard_normal((B, 4, 4, D)).astype(np.float32)
    seg = rng.integers(0, 3, (B, 4 * upsample, 4 * upsample)).astype(np.int32)
    labels = np.array([1, 2], np.int32)
    got = np.asarray(per_item_masked_pooling(
        jnp.asarray(emb), jnp.asarray(seg), jnp.asarray(labels),
        upsample=upsample))
    full = np.repeat(np.repeat(emb, upsample, 1), upsample, 2)
    for b in range(B):
        sel = full[b][seg[b] == labels[b]]
        want = sel.mean(0) if len(sel) else np.zeros(D)
        np.testing.assert_allclose(got[b], want, rtol=1e-5, atol=1e-6)


def _np_tv(x, s):
    full = np.repeat(np.repeat(x, s, 1), s, 2).astype(np.float64)
    return (np.abs(full[:, :, :-1] - full[:, :, 1:]).mean()
            + np.abs(full[:, :-1] - full[:, 1:]).mean())


@pytest.mark.parametrize("upsample", [1, 2])
def test_tv_value_and_gradient_match_numpy(upsample):
    rng = np.random.default_rng(15)
    x = rng.standard_normal((B, 5, 6, 3)).astype(np.float32)
    val, grad = jax.value_and_grad(
        lambda x: total_variation_loss(x, upsample=upsample))(jnp.asarray(x))
    np.testing.assert_allclose(float(val), _np_tv(x, upsample), rtol=1e-5)
    # central differences of the numpy oracle (|.| is smooth away from ties)
    eps, num = 1e-3, np.zeros_like(x, np.float64)
    for idx in np.ndindex(*x.shape):
        d = np.zeros_like(x)
        d[idx] = eps
        num[idx] = (_np_tv(x + d, upsample) - _np_tv(x - d, upsample)) / (2 * eps)
    np.testing.assert_allclose(np.asarray(grad), num, rtol=1e-2, atol=1e-4)


def test_l2_normalize_value_and_gradient_match_numpy():
    rng = np.random.default_rng(16)
    x = rng.standard_normal((4, 7)).astype(np.float32)
    c = rng.standard_normal((4, 7)).astype(np.float32)
    got = np.asarray(l2_normalize(jnp.asarray(x), axis=-1))
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    np.testing.assert_allclose(got, x / n, rtol=1e-6)
    _, vjp = jax.vjp(lambda x: l2_normalize(x, axis=-1), jnp.asarray(x))
    # d(x/|x|)^T c = (c - u (u.c)) / |x|
    u = x / n
    want = (c - u * np.sum(u * c, -1, keepdims=True)) / n
    np.testing.assert_allclose(np.asarray(vjp(jnp.asarray(c))[0]), want,
                               rtol=1e-5, atol=1e-6)
