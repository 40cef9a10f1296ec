"""Loss-stack tests: masked static-shape formulations must match dense
reference-style oracles computed with numpy/torch on the same selections."""

import numpy as np
import torch
import torch.nn.functional as TF
import jax
import jax.numpy as jnp

from rangeclip.losses.infonce import (
    area_image_infonce,
    build_contrast_mask,
    pixel_text_infonce,
    sample_pixels,
)
from rangeclip.losses.pooling import masked_average_pooling, per_item_masked_pooling
from rangeclip.losses.smoothness import total_variation_loss
from rangeclip.losses.hybrid import HybridLossConfig, compute_hybrid_loss


def test_pixel_text_infonce_equals_reduced_set_ce():
    """Masked full-C CE == torch CE over the gathered contrast subset
    (reference model.py:271-291 semantics)."""
    rng = np.random.default_rng(0)
    N, C, D = 64, 20, 16
    samples = rng.standard_normal((N, D)).astype(np.float32)
    text = rng.standard_normal((C, D)).astype(np.float32)
    labels = rng.integers(1, 8, size=N)
    valid = (rng.random(N) > 0.3).astype(np.float32)
    contrast = np.zeros(C, bool)
    contrast[1:8] = True  # all labels present
    contrast[[10, 12, 15]] = True  # distractors
    temp = 0.07

    got = float(
        pixel_text_infonce(
            jnp.asarray(samples), jnp.asarray(labels), jnp.asarray(valid),
            jnp.asarray(text), jnp.asarray(contrast), jnp.float32(temp),
        )
    )

    # torch oracle on the packed valid subset with a gathered table
    contrast_idx = np.where(contrast)[0]
    remap = {c: i for i, c in enumerate(contrast_idx)}
    keep = valid > 0
    s = torch.from_numpy(samples[keep])
    t = torch.from_numpy(text[contrast_idx])
    y = torch.tensor([remap[int(l)] for l in labels[keep]])
    logits = TF.normalize(s, dim=1) @ TF.normalize(t, dim=1).T / temp
    want = TF.cross_entropy(logits, y).item()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_pixel_text_infonce_degenerate_cases():
    N, C, D = 8, 10, 4
    samples = jnp.ones((N, D))
    labels = jnp.ones((N,), jnp.int32)
    text = jnp.ones((C, D))
    # fewer than 2 contrast classes -> 0
    one_class = jnp.zeros((C,), bool).at[1].set(True)
    assert float(pixel_text_infonce(samples, labels, jnp.ones(N), text, one_class,
                                    jnp.float32(0.07))) == 0.0
    # no valid samples -> 0
    full = jnp.ones((C,), bool)
    assert float(pixel_text_infonce(samples, labels, jnp.zeros(N), text, full,
                                    jnp.float32(0.07))) == 0.0


def test_area_image_infonce_matches_packed_torch():
    rng = np.random.default_rng(1)
    B, D = 6, 8
    area = rng.standard_normal((B, D)).astype(np.float32)
    img = rng.standard_normal((B, D)).astype(np.float32)
    valid = np.array([1, 1, 0, 1, 1, 0], np.float32)
    temp = 0.1

    got = float(area_image_infonce(jnp.asarray(area), jnp.asarray(img),
                                   jnp.asarray(valid), jnp.float32(temp)))

    keep = valid > 0
    a = TF.normalize(torch.from_numpy(area[keep]), dim=1)
    i = TF.normalize(torch.from_numpy(img[keep]), dim=1)
    logits = a @ i.T / temp
    want = TF.cross_entropy(logits, torch.arange(int(keep.sum()))).item()
    np.testing.assert_allclose(got, want, rtol=1e-5)

    # <2 valid instances -> 0 (reference dummy branch model.py:322-326)
    assert float(area_image_infonce(jnp.asarray(area), jnp.asarray(img),
                                    jnp.asarray(np.eye(1, B, 0)[0].astype(np.float32)),
                                    jnp.float32(temp))) == 0.0


def test_total_variation_matches_torch_l1():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 11, 5)).astype(np.float32)
    got = float(total_variation_loss(jnp.asarray(x)))
    xt = torch.from_numpy(np.transpose(x, (0, 3, 1, 2)))
    want = (
        TF.l1_loss(xt[:, :, :, :-1], xt[:, :, :, 1:])
        + TF.l1_loss(xt[:, :, :-1, :], xt[:, :, 1:, :])
    ).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_total_variation_sample_weight_excludes_padding():
    """TV with 0/1 sample weights == exact TV of the valid sub-batch, and
    the all-ones weighted path is BIT-identical to the unweighted one
    (garbage padded items contribute zero value and zero gradient)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 8, 9, 6)).astype(np.float32)
    pad = np.concatenate([x, 1e6 * np.ones((2, 8, 9, 6), np.float32)])
    w = jnp.asarray([1.0, 1.0, 1.0, 0.0, 0.0])

    want = float(total_variation_loss(jnp.asarray(x)))
    got = float(total_variation_loss(jnp.asarray(pad), sample_weight=w))
    np.testing.assert_allclose(got, want, rtol=1e-6)

    ones = jnp.ones((3,))
    assert float(total_variation_loss(jnp.asarray(x), sample_weight=ones)) \
        == want

    g = jax.grad(lambda t: total_variation_loss(t, sample_weight=w))(
        jnp.asarray(pad))
    assert float(jnp.max(jnp.abs(g[3:]))) == 0.0
    g_ref = jax.grad(lambda t: total_variation_loss(t))(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(g[:3]), np.asarray(g_ref),
                               rtol=1e-6, atol=1e-8)


def test_weighted_losses_match_torch_reference():
    """weighted_l1/l2 vs a transcription of loss_utils.py:9-69 — incl. the
    reference's non-broadcast denominator ([N,1,H,W] weights against
    [N,3,H,W] losses) and the normalize variants."""
    from rangeclip.losses.weighted import weighted_l1_loss, weighted_l2_loss

    rng = np.random.default_rng(3)
    src = rng.standard_normal((2, 3, 7, 5)).astype(np.float32)  # NCHW order
    tgt = rng.standard_normal((2, 3, 7, 5)).astype(np.float32)
    w = (rng.random((2, 1, 7, 5)) > 0.3).astype(np.float32)

    st, tt, wt = (torch.from_numpy(a) for a in (src, tgt, w))
    eps = 1e-8
    for normalize in (False, True):
        l1 = torch.abs(st - tt)
        l2 = (st - tt) ** 2
        if normalize:
            l1 = l1 / (torch.abs(tt) + eps)
            l2 = l2 / (tt ** 2 + eps)
        want1 = torch.mean(torch.sum(wt * l1, dim=[1, 2, 3])
                           / torch.sum(wt, dim=[1, 2, 3])).item()
        want2 = torch.mean(torch.sum(wt * l2, dim=[1, 2, 3])
                           / torch.sum(wt, dim=[1, 2, 3])).item()
        got1 = float(weighted_l1_loss(jnp.asarray(src), jnp.asarray(tgt),
                                      jnp.asarray(w), normalize=normalize))
        got2 = float(weighted_l2_loss(jnp.asarray(src), jnp.asarray(tgt),
                                      jnp.asarray(w), normalize=normalize))
        np.testing.assert_allclose(got1, want1, rtol=1e-6)
        np.testing.assert_allclose(got2, want2, rtol=1e-6)

    # w=None counts every element (reference w=ones_like(src))
    np.testing.assert_allclose(
        float(weighted_l1_loss(jnp.asarray(src), jnp.asarray(tgt))),
        torch.mean(torch.abs(st - tt)).item(), rtol=1e-6)


def test_total_variation_custom_vjp_matches_autodiff():
    """The fused backward (smoothness.py _tv_bwd) vs XLA autodiff of the
    same forward — including exact ties, where both use JAX's +1 slope."""
    from rangeclip.losses.smoothness import _tv_value

    rng = np.random.default_rng(7)
    for dtype in (jnp.float32, jnp.bfloat16):
        for s in (1, 2):
            x = jnp.asarray(rng.standard_normal((2, 8, 9, 16)), dtype)
            x = x.at[0, 2, 3].set(x[0, 2, 4])  # exact horizontal tie
            va, ga = jax.value_and_grad(lambda t: _tv_value(t, s))(x)
            vb, gb = jax.value_and_grad(
                lambda t: total_variation_loss(t, s))(x)
            assert float(va) == float(vb)
            tol = 1e-6 if dtype == jnp.float32 else 5e-3
            np.testing.assert_allclose(
                np.asarray(ga, np.float32), np.asarray(gb, np.float32),
                rtol=tol, atol=tol * 1e-2)


def test_masked_average_pooling_matches_loop_oracle():
    rng = np.random.default_rng(3)
    B, H, W, D = 2, 6, 5, 7
    emb = rng.standard_normal((B, H, W, D)).astype(np.float32)
    seg = rng.integers(0, 4, size=(B, H, W))
    obj = np.array([1, 3, 9])  # 9 absent -> zero row

    got = np.asarray(masked_average_pooling(jnp.asarray(emb), jnp.asarray(seg),
                                            jnp.asarray(obj)))
    want = np.zeros((3, D), np.float32)
    for i, o in enumerate(obj):
        m = seg == o
        if m.any():
            want[i] = emb[m].sum(0) / m.sum()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_per_item_masked_pooling():
    rng = np.random.default_rng(4)
    B, H, W, D = 3, 4, 4, 5
    emb = rng.standard_normal((B, H, W, D)).astype(np.float32)
    seg = rng.integers(0, 3, size=(B, H, W))
    labels = np.array([1, 2, 7])  # 7 absent in item 2 -> zero row

    got = np.asarray(per_item_masked_pooling(jnp.asarray(emb), jnp.asarray(seg),
                                             jnp.asarray(labels)))
    for b in range(B):
        m = seg[b] == labels[b]
        want = emb[b][m].sum(0) / m.sum() if m.any() else np.zeros(D)
        np.testing.assert_allclose(got[b], want, rtol=1e-5, atol=1e-6)


def test_sample_pixels_shapes_and_background_mask():
    key = jax.random.key(0)
    emb = jnp.ones((2, 8, 8, 4))
    tgt = jnp.zeros((2, 8, 8), jnp.int32).at[:, :4].set(3)
    samples, labels, valid = sample_pixels(key, emb, tgt, 0.7)
    n = int(0.7 * 64)
    assert samples.shape == (2 * n, 4)
    assert labels.shape == (2 * n,)
    np.testing.assert_array_equal(np.asarray(valid), np.asarray(labels) > 0)


def test_build_contrast_mask_composition():
    """GT labels always in; distractor count respects the curriculum; medium
    pool only used when n_medium > 0."""
    C = 40
    labels = jnp.array([1, 2, 2, 3])
    valid = jnp.ones((4,), jnp.float32)
    medium = np.zeros((C, C), bool)
    hard = np.zeros((C, C), bool)
    medium[1, 10:15] = True  # medium set of label 1
    hard[2, 20:25] = True  # hard set of label 2
    hard[3, 2] = True  # in-GT distractor must be excluded

    key = jax.random.key(1)
    mask = np.asarray(
        build_contrast_mask(
            key, labels, valid, C, jnp.asarray(medium), jnp.asarray(hard),
            k_distractors=8, pct_medium=0.0, pct_hard=0.5,
        )
    )
    assert mask[[1, 2, 3]].all()  # GT present
    # n_hard=4 -> at least 4 picks from the hard pool (20..24); random picks
    # (n_rand=4) may add more anywhere outside GT
    assert mask[20:25].sum() >= 4
    assert mask.sum() == 3 + 4 + 4

    # pct_medium > 0 activates the medium pool
    mask2 = np.asarray(
        build_contrast_mask(
            key, labels, valid, C, jnp.asarray(medium), jnp.asarray(hard),
            k_distractors=8, pct_medium=0.5, pct_hard=0.25,
        )
    )
    # n_medium=4, n_hard=2 -> 6 from medium∪hard pool, 2 random (which may
    # also land in unchosen pool classes)
    assert mask2[[1, 2, 3]].all()
    assert (mask2[10:15].sum() + mask2[20:25].sum()) >= 6
    assert mask2.sum() == 3 + 6 + 2


def test_hybrid_loss_composes_and_is_finite():
    key = jax.random.key(0)
    B, H, W, D, C = 2, 16, 16, 8, 30
    k1, k2, k3 = jax.random.split(key, 3)
    emb = jax.random.normal(k1, (B, H, W, D))
    seg = jax.random.randint(k2, (B, H, W), 0, 5)
    text = jax.random.normal(k3, (C, D))
    medium = jnp.zeros((C, C), bool)
    hard = jnp.zeros((C, C), bool)

    total, info = compute_hybrid_loss(
        key, emb, seg, text, medium, hard,
        temperature_text=jnp.float32(0.07), temperature_image=jnp.float32(0.1),
        pct_medium=0.25, pct_hard=0.5,
        area_embeddings=jax.random.normal(k1, (B, D)),
        image_embeddings=jax.random.normal(k2, (B, D)),
        area_valid=jnp.ones((B,)),
        config=HybridLossConfig(),
    )
    assert np.isfinite(float(total))
    expected = (
        1.0 * float(info["text_contrastive_loss"])
        + 0.5 * float(info["image_contrastive_loss"])
        + 2e2 * float(info["smoothness_loss"])
    )
    np.testing.assert_allclose(float(total), expected, rtol=1e-5)
    # loss must be differentiable end-to-end
    grad = jax.grad(
        lambda e: compute_hybrid_loss(
            key, e, seg, text, medium, hard,
            temperature_text=jnp.float32(0.07),
            temperature_image=jnp.float32(0.1),
            pct_medium=0.25, pct_hard=0.5,
        )[0]
    )(emb)
    assert np.isfinite(np.asarray(grad)).all()


def test_multiplicity_weighting_equals_gathered_sampling():
    """The train path weights all pixels by sampled multiplicity; for the SAME
    draws this is exactly the mean over the gathered sample list."""
    import jax
    from rangeclip.losses.infonce import pixel_text_infonce

    rng = np.random.default_rng(7)
    B, H, W, D, C = 2, 8, 8, 16, 12
    emb = jnp.asarray(rng.standard_normal((B, H, W, D)), jnp.float32)
    seg = jnp.asarray(rng.integers(0, 6, (B, H, W)), jnp.int32)
    text = jnp.asarray(rng.standard_normal((C, D)), jnp.float32)
    mask = jnp.asarray(np.ones(C, bool))
    temp = jnp.float32(0.07)

    n = 40
    idx = rng.integers(0, H * W, (B, n))

    # gathered-sample formulation
    emb_flat = emb.reshape(B, H * W, D)
    seg_flat = np.asarray(seg.reshape(B, H * W))
    samples = jnp.asarray(
        np.stack([np.asarray(emb_flat[b])[idx[b]] for b in range(B)])
    ).reshape(B * n, D)
    labels = jnp.asarray(
        np.stack([seg_flat[b][idx[b]] for b in range(B)])
    ).reshape(B * n)
    valid = (labels > 0).astype(jnp.float32)
    loss_gather = pixel_text_infonce(samples, labels, valid, text, mask, temp)

    # multiplicity formulation over ALL pixels
    counts = np.zeros((B, H * W), np.float32)
    for b in range(B):
        np.add.at(counts[b], idx[b], 1.0)
    all_labels = jnp.asarray(seg_flat.reshape(-1))
    weights = jnp.asarray(counts.reshape(-1)) * (all_labels > 0)
    loss_mult = pixel_text_infonce(
        emb.reshape(B * H * W, D), all_labels, weights, text, mask, temp
    )
    np.testing.assert_allclose(float(loss_gather), float(loss_mult), rtol=1e-5)


def _nearest_up(x, s):
    """Nearest xs upsample of [B, h, w, D]."""
    B, h, w, D = x.shape
    return jnp.broadcast_to(
        x[:, :, None, :, None, :], (B, h, s, w, s, D)
    ).reshape(B, h * s, w * s, D)


def test_tv_upsample_identity():
    """TV of the nearest xs upsample == native TV with per-direction
    pair-count scaling (smoothness.py upsample)."""
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((2, 6, 10, 8)).astype(np.float32))
    for s in (2, 3):
        full = total_variation_loss(_nearest_up(x, s))
        native = total_variation_loss(x, upsample=s)
        np.testing.assert_allclose(float(native), float(full), rtol=1e-6)


def test_per_item_pooling_upsample_identity():
    """Pooling the upsampled field over the full-res mask == native pooling
    with child-count weights (pooling.py upsample)."""
    rng = np.random.default_rng(4)
    B, h, w, D, s = 2, 5, 7, 8, 2
    x = jnp.asarray(rng.standard_normal((B, h, w, D)).astype(np.float32))
    seg = jnp.asarray(rng.integers(0, 4, (B, h * s, w * s)).astype(np.int32))
    labels = jnp.asarray([1, 2], jnp.int32)
    full = per_item_masked_pooling(_nearest_up(x, s), seg, labels)
    native = per_item_masked_pooling(x, seg, labels, upsample=s)
    np.testing.assert_allclose(np.asarray(native), np.asarray(full),
                               rtol=1e-5, atol=1e-6)


def test_infonce_label_slots_equal_upsampled():
    """[S, N] label slots on the native field == flat CE on the nearest
    upsampled field (the native-resolution training identity)."""
    rng = np.random.default_rng(5)
    B, h, w, D, C, s = 2, 4, 4, 16, 12, 2
    x = jnp.asarray(rng.standard_normal((B, h, w, D)).astype(np.float32))
    text = jnp.asarray(rng.standard_normal((C, D)).astype(np.float32))
    seg = rng.integers(0, 6, (B, h * s, w * s)).astype(np.int32)
    weights = (rng.random((B, h * s, w * s)) * 2).astype(np.float32) * (seg > 0)
    mask = np.zeros(C, bool)
    mask[list(range(8))] = True
    temp = jnp.float32(0.07)

    full = pixel_text_infonce(
        _nearest_up(x, s).reshape(-1, D), jnp.asarray(seg.reshape(-1)),
        jnp.asarray(weights.reshape(-1)), text, jnp.asarray(mask), temp)

    lab = jnp.asarray(seg).reshape(B, h, s, w, s).transpose(
        2, 4, 0, 1, 3).reshape(s * s, B * h * w)
    val = jnp.asarray(weights).reshape(B, h, s, w, s).transpose(
        2, 4, 0, 1, 3).reshape(s * s, B * h * w)
    native = pixel_text_infonce(x.reshape(-1, D), lab, val, text,
                                jnp.asarray(mask), temp)
    np.testing.assert_allclose(float(native), float(full), rtol=1e-6)

    # gradients agree too: d/dx of native slots == pullback of the
    # upsample on d/dX of the full-res formulation
    def loss_native(xx):
        return pixel_text_infonce(xx.reshape(-1, D), lab, val, text,
                                  jnp.asarray(mask), temp)

    def loss_full(xx):
        return pixel_text_infonce(
            _nearest_up(xx, s).reshape(-1, D), jnp.asarray(seg.reshape(-1)),
            jnp.asarray(weights.reshape(-1)), text, jnp.asarray(mask), temp)

    g_native = jax.grad(loss_native)(x)
    g_full = jax.grad(loss_full)(x)
    np.testing.assert_allclose(np.asarray(g_native), np.asarray(g_full),
                               rtol=1e-4, atol=1e-6)


def test_hybrid_loss_native_equals_fullres():
    """compute_hybrid_loss(label_upsample=2) on the native field == the
    full-resolution loss on the nearest x2 upsample (same RNG key)."""
    rng = np.random.default_rng(6)
    B, h, w, D, C, s = 2, 8, 8, 16, 20, 2
    x = jnp.asarray(rng.standard_normal((B, h, w, D)).astype(np.float32))
    x = x / jnp.linalg.norm(x, axis=-1, keepdims=True)
    seg = jnp.asarray(rng.integers(0, 6, (B, h * s, w * s)).astype(np.int32))
    text = jnp.asarray(rng.standard_normal((C, D)).astype(np.float32))
    med = jnp.zeros((C, C), bool)
    hard = jnp.zeros((C, C), bool)
    area = jnp.asarray(rng.standard_normal((B, D)).astype(np.float32))
    img = jnp.asarray(rng.standard_normal((B, D)).astype(np.float32))
    key = jax.random.key(11)
    kwargs = dict(
        temperature_text=jnp.float32(0.07),
        temperature_image=jnp.float32(0.1),
        pct_medium=0.2, pct_hard=0.3,
        area_embeddings=area, image_embeddings=img,
        area_valid=jnp.ones((B,), jnp.float32),
        sample_weight=jnp.asarray([1.0, 1.0], jnp.float32),
    )
    full, info_full = compute_hybrid_loss(
        key, _nearest_up(x, s), seg, text, med, hard, **kwargs)
    native, info_native = compute_hybrid_loss(
        key, x, seg, text, med, hard, label_upsample=s, **kwargs)
    np.testing.assert_allclose(float(native), float(full), rtol=1e-5)
    for k in ("text_contrastive_loss", "smoothness_loss",
              "image_contrastive_loss"):
        np.testing.assert_allclose(float(info_native[k]), float(info_full[k]),
                                   rtol=1e-5, atol=1e-7)


def test_multinomial_counts_law():
    """Binomial-splitting counts: exact total, correct Multinomial moments,
    zero mass on padding bins (non-power-of-two), slot layout matches the
    flat layout's per-image totals."""
    from rangeclip.losses.infonce import (
        multinomial_counts,
        sample_pixel_multiplicities_multinomial,
    )

    n, n_bins = 1000, 48  # non-power-of-two
    totals = []
    means = np.zeros(n_bins)
    R = 40
    for r in range(R):
        c = np.asarray(multinomial_counts(jax.random.key(r), n, n_bins,
                                          batch=2))
        assert c.shape == (2, n_bins)
        np.testing.assert_array_equal(c.sum(axis=1), [n, n])
        assert (c >= 0).all()
        means += c.mean(axis=0) / R
    # E[count] = n / n_bins = 20.83; loose tolerance over 80 draws/bin
    np.testing.assert_allclose(means, n / n_bins, rtol=0.25)
    # empirical variance should be near Binomial(n, 1/n_bins) variance
    var_expected = n * (1 / n_bins) * (1 - 1 / n_bins)
    c_many = np.concatenate([
        np.asarray(multinomial_counts(jax.random.key(100 + r), n, n_bins))
        for r in range(60)
    ])
    assert 0.5 * var_expected < c_many.var() < 2.0 * var_expected

    # slotted layout: per-image draw total is exact and background-masked
    seg = np.zeros((2, 8, 8), np.int32)
    seg[:, :4] = 3  # half the pixels are background (label 0)
    w, lab = sample_pixel_multiplicities_multinomial(
        jax.random.key(1), jnp.asarray(seg), percent=0.5, slots=2)
    assert w.shape == lab.shape == (4, 2 * 4 * 4)
    assert float(jnp.sum(w)) <= 0.5 * 64 * 2  # background zeroed
    np.testing.assert_array_equal(
        np.asarray(lab), np.where(np.asarray(lab) > 0, 3, 0))


def test_hybrid_loss_multinomial_sampler_runs():
    """pixel_sampler='multinomial' produces a finite loss on the native
    path (a train configuration, exercised here on CPU)."""
    import dataclasses as dc

    rng = np.random.default_rng(8)
    B, h, w, D, C, s = 2, 8, 8, 16, 20, 2
    x = jnp.asarray(rng.standard_normal((B, h, w, D)).astype(np.float32))
    x = x / jnp.linalg.norm(x, axis=-1, keepdims=True)
    seg = jnp.asarray(rng.integers(0, 6, (B, h * s, w * s)).astype(np.int32))
    text = jnp.asarray(rng.standard_normal((C, D)).astype(np.float32))
    med = jnp.zeros((C, C), bool)
    cfg = HybridLossConfig(pixel_sampler="multinomial")
    total, info = compute_hybrid_loss(
        jax.random.key(3), x, seg, text, med, med,
        temperature_text=jnp.float32(0.07),
        temperature_image=jnp.float32(0.1),
        pct_medium=0.2, pct_hard=0.3, config=cfg, label_upsample=s)
    assert np.isfinite(float(total)) and float(total) > 0
    # and the flat (s=1) layout too
    x_full = _nearest_up(x, s)
    total2, _ = compute_hybrid_loss(
        jax.random.key(3), x_full, seg, text, med, med,
        temperature_text=jnp.float32(0.07),
        temperature_image=jnp.float32(0.1),
        pct_medium=0.2, pct_hard=0.3, config=cfg)
    assert np.isfinite(float(total2)) and float(total2) > 0


def test_histogram_slot_remap_identity():
    """Slot-ordered histogram (index remap before the scatter) is
    bit-identical to transposing the flat histogram afterwards — same key,
    same draws."""
    from rangeclip.losses.infonce import sample_pixel_multiplicities

    rng = np.random.default_rng(11)
    B, H, W, s = 3, 8, 12, 2
    h, w = H // s, W // s
    seg = jnp.asarray(rng.integers(0, 5, (B, H, W)).astype(np.int32))
    key = jax.random.key(42)

    w_flat, lab_flat = sample_pixel_multiplicities(key, seg, 0.7)
    w_slot, lab_slot = sample_pixel_multiplicities(key, seg, 0.7, slots=s)

    w_ref = np.asarray(w_flat).reshape(B, h, s, w, s).transpose(
        2, 4, 0, 1, 3).reshape(s * s, B * h * w)
    lab_ref = np.asarray(lab_flat).reshape(B, h, s, w, s).transpose(
        2, 4, 0, 1, 3).reshape(s * s, B * h * w)
    np.testing.assert_array_equal(np.asarray(w_slot), w_ref)
    np.testing.assert_array_equal(np.asarray(lab_slot), lab_ref)


def test_class_balanced_weighting_equalizes_class_mass():
    """class_balanced=True (opt-in): every PRESENT class contributes equal
    total weight to the pixel-text CE and sum(valid) is preserved, so the
    loss normalization is unchanged.  Verified against an instrumented
    call that captures the weights the CE actually receives."""
    import rangeclip.losses.hybrid as hybrid_mod
    from rangeclip.losses.hybrid import HybridLossConfig, compute_hybrid_loss

    rng = np.random.default_rng(0)
    B, H, W, D, C = 2, 8, 8, 16, 12
    emb = jnp.asarray(rng.standard_normal((B, H, W, D)), jnp.float32)
    # heavy imbalance: label 3 dominates, a few pixels of 5 and 7
    seg = np.full((B, H, W), 3, np.int32)
    seg[:, :2, :2] = 5
    seg[0, 7, 7] = 7
    text = jnp.asarray(rng.standard_normal((C, D)), jnp.float32)
    med = jnp.zeros((C, C), bool)

    captured = {}
    orig = hybrid_mod.pixel_text_infonce

    def spy(samples, labels, valid, *a, **kw):
        captured["labels"] = np.asarray(labels).ravel()
        captured["valid"] = np.asarray(valid).ravel()
        return orig(samples, labels, valid, *a, **kw)

    hybrid_mod.pixel_text_infonce = spy
    try:
        for balanced in (False, True):
            loss, _ = compute_hybrid_loss(
                jax.random.key(1), emb, jnp.asarray(seg), text, med, med,
                jnp.float32(0.07), jnp.float32(0.1), 0.0, 0.0,
                config=HybridLossConfig(
                    w_image=0.0, w_smooth=0.0, class_balanced=balanced),
            )
            assert np.isfinite(float(loss))
            lab, val = captured["labels"], captured["valid"]
            mass = {c: val[lab == c].sum() for c in (3, 5, 7)}
            if balanced:
                total_b = val.sum()
                assert np.allclose([mass[3], mass[5], mass[7]],
                                   total_b / 3, rtol=1e-5), mass
                # normalization preserved vs the unbalanced call
                assert np.isclose(total_b, total_u, rtol=1e-6)
            else:
                total_u = val.sum()
                assert mass[3] > 10 * mass[5] > 0  # the imbalance is real
    finally:
        hybrid_mod.pixel_text_infonce = orig
