"""DepthUNet forward/predict and the fused train step (tiny shapes, CPU)."""

import numpy as np
import jax
import jax.numpy as jnp

from rangeclip.models.depth_unet import (
    DepthUNet,
    DepthUNetConfig,
    build_candidate_mask,
)
from rangeclip.losses.hybrid import HybridLossConfig
from rangeclip.training.optim import make_optimizer
from rangeclip.training.state import create_train_state
from rangeclip.training.train_step import make_train_step

TINY = DepthUNetConfig(
    encoder_filters=(8, 16, 16, 16, 32), embedding_dim=32, use_batch_norm=True
)


def _tiny_model():
    return DepthUNet(TINY)


def test_forward_shapes_and_norm():
    model = _tiny_model()
    x = jnp.ones((2, 32, 32, 1))
    vars_ = model.init(jax.random.key(0), x, train=False)
    (emb, tt, ti), _ = model.apply(vars_, x, train=True, mutable=["batch_stats"])
    assert emb.shape == (2, 32, 32, 32)
    # decoder output is L2-normalized over channels (decoder.py:113-116)
    norms = np.asarray(jnp.linalg.norm(emb, axis=-1))
    np.testing.assert_allclose(norms, 1.0, atol=1e-4)
    np.testing.assert_allclose(float(tt), 0.07, rtol=1e-4)
    np.testing.assert_allclose(float(ti), 0.1, rtol=1e-4)


def test_predict_respects_candidate_mask():
    model = _tiny_model()
    x = jax.random.normal(jax.random.key(1), (1, 32, 32, 1))
    vars_ = model.init(jax.random.key(0), x, train=False)
    C, D = 12, 32
    text = jax.random.normal(jax.random.key(2), (C, D))
    seg = jnp.zeros((1, 32, 32), jnp.int32).at[:, :16].set(3)

    mask = build_candidate_mask(jax.random.key(3), seg, C, num_negatives=4)
    m = np.asarray(mask)
    assert m[0] and m[3]  # GT labels (incl. background) always in
    assert m.sum() == 2 + 4  # 2 GT + 4 negatives

    topk, emb, temp = model.apply(
        vars_, x, text, mask, 3, method=DepthUNet.predict
    )
    assert topk.shape == (1, 32, 32, 3)
    # every predicted index must be inside the candidate set
    assert m[np.asarray(topk).reshape(-1)].all()


def test_predict_gathered_candidates_bit_match_masked():
    """predict(candidate_indices=) gathers the reduced table (the
    reference's own formulation, model.py:147-161) instead of masking the
    full one; ascending slot order makes tie-breaking identical, so the
    two paths must return bit-identical labels."""
    from rangeclip.models.depth_unet import (
        build_candidate_indices,
        candidate_indices_from_mask,
    )

    model = _tiny_model()
    x = jax.random.normal(jax.random.key(1), (2, 32, 32, 1))
    vars_ = model.init(jax.random.key(0), x, train=False)
    C, D = 12, 32
    text = jax.random.normal(jax.random.key(2), (C, D))
    seg = jnp.zeros((2, 32, 32), jnp.int32).at[:, :16].set(3)

    mask = build_candidate_mask(jax.random.key(3), seg, C, num_negatives=4)
    ci = build_candidate_indices(jax.random.key(3), seg, C, 4, capacity=8)
    # same draw as the mask, ascending, -1-padded
    np.testing.assert_array_equal(
        np.asarray(ci), np.asarray(candidate_indices_from_mask(mask, 8)))
    m = np.asarray(mask)
    assert (np.sort(np.asarray(ci)[np.asarray(ci) >= 0])
            == np.nonzero(m)[0]).all()

    topk_m, emb_m, _ = model.apply(
        vars_, x, text, mask, 3, method=DepthUNet.predict)
    topk_g, emb_g, _ = model.apply(
        vars_, x, text, None, 3, method=DepthUNet.predict,
        candidate_indices=ci)
    np.testing.assert_array_equal(np.asarray(topk_m), np.asarray(topk_g))
    np.testing.assert_array_equal(np.asarray(emb_m), np.asarray(emb_g))

    # capacity larger than C pads with -1 and still matches
    ci_big = candidate_indices_from_mask(mask, 16)
    topk_b, _, _ = model.apply(
        vars_, x, text, None, 3, method=DepthUNet.predict,
        candidate_indices=ci_big)
    np.testing.assert_array_equal(np.asarray(topk_m), np.asarray(topk_b))


def test_train_step_runs_and_descends():
    model = _tiny_model()
    opt = make_optimizer(weight_decay=1e-4)
    state = create_train_state(jax.random.key(0), TINY, opt, (1, 32, 32, 1))

    A, B, H, W, C, D = 2, 2, 32, 32, 20, 32
    key = jax.random.key(1)
    batch = {
        "depth": jax.random.normal(key, (A, B, H, W, 1)),
        "segmentation": jax.random.randint(key, (A, B, H, W), 0, 6),
        "object_label": jnp.ones((A, B), jnp.int32),
        "image_embeddings": jax.random.normal(key, (A, B, D)),
        "sample_valid": jnp.ones((A, B), jnp.float32),
    }
    text = jax.random.normal(jax.random.key(2), (C, D))
    medium = jnp.zeros((C, C), bool)
    hard = jnp.zeros((C, C), bool)

    step = make_train_step(model, opt, HybridLossConfig(), accum_steps=A,
                           donate=False)
    s1, info1 = step(state, batch, jax.random.key(3), jnp.float32(1e-3),
                     jnp.float32(0.25), jnp.float32(0.5), text, medium, hard)
    assert int(s1.step) == 1
    assert np.isfinite(float(info1["total_loss"]))
    assert float(info1["grad_norm"]) > 0

    # params actually moved
    delta = jax.tree.map(lambda a, b: float(jnp.abs(a - b).max()),
                         state.params, s1.params)
    assert max(jax.tree.leaves(delta)) > 0

    # a few more steps on the same batch should reduce the loss
    s = s1
    losses = [float(info1["total_loss"])]
    for i in range(3):
        s, info = step(s, batch, jax.random.key(3), jnp.float32(1e-3),
                       jnp.float32(0.25), jnp.float32(0.5), text, medium, hard)
        losses.append(float(info["total_loss"]))
    assert losses[-1] < losses[0]


def test_freeze_encoder_pins_encoder_while_decoder_trains():
    """Frozen-encoder finetune (train_util.py:158, model.py:395-399):
    encoder params and BN stats are bit-identical after training steps
    while the decoder moves."""
    import dataclasses

    cfg = dataclasses.replace(TINY, freeze_encoder=True)
    model = DepthUNet(cfg)
    opt = make_optimizer(weight_decay=1e-4, freeze_encoder=True)
    state = create_train_state(jax.random.key(0), cfg, opt, (1, 32, 32, 1))

    A, B, H, W, C, D = 2, 2, 32, 32, 20, 32
    key = jax.random.key(1)
    batch = {
        "depth": jax.random.normal(key, (A, B, H, W, 1)),
        "segmentation": jax.random.randint(key, (A, B, H, W), 0, 6),
        "object_label": jnp.ones((A, B), jnp.int32),
        "image_embeddings": jax.random.normal(key, (A, B, D)),
        "sample_valid": jnp.ones((A, B), jnp.float32),
    }
    text = jax.random.normal(jax.random.key(2), (C, D))
    medium = jnp.zeros((C, C), bool)
    hard = jnp.zeros((C, C), bool)

    step = make_train_step(model, opt, HybridLossConfig(), accum_steps=A,
                           donate=False)
    s = state
    for i in range(3):
        s, info = step(s, batch, jax.random.key(3 + i), jnp.float32(1e-3),
                       jnp.float32(0.25), jnp.float32(0.5), text, medium, hard)
    assert np.isfinite(float(info["total_loss"]))

    enc_delta = jax.tree.map(lambda a, b: float(jnp.abs(a - b).max()),
                             state.params["depth_encoder"],
                             s.params["depth_encoder"])
    assert max(jax.tree.leaves(enc_delta)) == 0.0
    stats_delta = jax.tree.map(lambda a, b: float(jnp.abs(a - b).max()),
                               state.batch_stats["depth_encoder"],
                               s.batch_stats["depth_encoder"])
    assert max(jax.tree.leaves(stats_delta)) == 0.0

    dec_delta = jax.tree.map(lambda a, b: float(jnp.abs(a - b).max()),
                             state.params["depth_decoder"],
                             s.params["depth_decoder"])
    assert max(jax.tree.leaves(dec_delta)) > 0


def test_native_loss_train_step_equals_fullres():
    """make_train_step(native_losses=True) — losses at the decoder's native
    resolution via the upsample identities — produces the same losses and
    parameter updates as the full-resolution step (fp32, same keys)."""
    model = _tiny_model()
    opt = make_optimizer(weight_decay=1e-4)

    A, B, H, W, C, D = 2, 2, 32, 32, 20, 32
    key = jax.random.key(1)
    batch = {
        "depth": jax.random.normal(key, (A, B, H, W, 1)),
        "segmentation": jax.random.randint(key, (A, B, H, W), 0, 6),
        "object_label": jnp.ones((A, B), jnp.int32),
        "image_embeddings": jax.random.normal(key, (A, B, D)),
        "sample_valid": jnp.ones((A, B), jnp.float32),
    }
    text = jax.random.normal(jax.random.key(2), (C, D))
    medium = jnp.zeros((C, C), bool)
    hard = jnp.zeros((C, C), bool)

    states, infos = {}, {}
    for mode in (False, True):
        state = create_train_state(jax.random.key(0), TINY, opt, (1, H, W, 1))
        step = make_train_step(model, opt, HybridLossConfig(), accum_steps=A,
                               donate=False, native_losses=mode)
        s, info = step(state, batch, jax.random.key(3), jnp.float32(1e-3),
                       jnp.float32(0.25), jnp.float32(0.5), text, medium, hard)
        states[mode], infos[mode] = s, info

    for k in ("total_loss", "text_contrastive_loss", "smoothness_loss",
              "image_contrastive_loss"):
        np.testing.assert_allclose(float(infos[True][k]),
                                   float(infos[False][k]), rtol=1e-4,
                                   err_msg=k)
    deltas = jax.tree.map(
        lambda a, b: float(jnp.abs(a - b).max()),
        states[True].params, states[False].params)
    assert max(jax.tree.leaves(deltas)) < 1e-4


def test_bf16_training_tracks_fp32():
    """Codifies README's accuracy-parity claim as a checked regression:
    a bf16-compute training run (fp32 params) follows the fp32 run's loss
    trajectory to ~1% on identical data/seeds."""
    import dataclasses

    A, B, H, W, C, D = 2, 2, 32, 32, 20, 32
    key = jax.random.key(1)
    batch = {
        "depth": jax.random.normal(key, (A, B, H, W, 1)),
        "segmentation": jax.random.randint(key, (A, B, H, W), 0, 6),
        "object_label": jnp.ones((A, B), jnp.int32),
        "image_embeddings": jax.random.normal(key, (A, B, D)),
        "sample_valid": jnp.ones((A, B), jnp.float32),
    }
    text = jax.random.normal(jax.random.key(2), (C, D))
    medium = jnp.zeros((C, C), bool)
    hard = jnp.zeros((C, C), bool)

    traj = {}
    for mode, dtype in [("fp32", None), ("bf16", jnp.bfloat16)]:
        cfg = dataclasses.replace(TINY, dtype=dtype)
        model = DepthUNet(cfg)
        opt = make_optimizer(weight_decay=1e-4)
        state = create_train_state(jax.random.key(0), cfg, opt, (1, H, W, 1))
        step = make_train_step(model, opt, HybridLossConfig(), accum_steps=A,
                               donate=False)
        losses = []
        for i in range(6):
            state, info = step(state, batch, jax.random.key(7 + i),
                               jnp.float32(1e-3), jnp.float32(0.25),
                               jnp.float32(0.5), text, medium, hard)
            losses.append(float(info["total_loss"]))
        traj[mode] = np.asarray(losses)
        # params stay fp32 under the bf16 compute policy
        assert all(x.dtype == jnp.float32
                   for x in jax.tree.leaves(state.params))

    np.testing.assert_allclose(traj["bf16"], traj["fp32"], rtol=0.02)


def test_predict_native_scoring_identity():
    """Scoring at the decoder's native H/2 resolution and nearest-upsampling
    the top-k indices is EXACTLY the full-resolution prediction: the final
    decoder upsample is nearest (decoder.py:113-116) and normalize/score/
    top-k are per-pixel, so they commute with the pixel-replicating resize."""
    model = _tiny_model()
    x = jax.random.normal(jax.random.key(1), (2, 32, 32, 1))
    vars_ = model.init(jax.random.key(0), x, train=False)
    C = 12
    text = jax.random.normal(jax.random.key(2), (C, 32))
    seg = jax.random.randint(jax.random.key(3), (2, 32, 32), 0, 6)
    mask = build_candidate_mask(jax.random.key(4), seg, C, num_negatives=4)

    topk_full, emb_full, t_full = model.apply(
        vars_, x, text, mask, 5, method=DepthUNet.predict, score_native=False
    )
    topk_nat, emb_nat, t_nat = model.apply(
        vars_, x, text, mask, 5, method=DepthUNet.predict, score_native=True
    )
    assert topk_nat.shape == topk_full.shape == (2, 32, 32, 5)
    np.testing.assert_array_equal(np.asarray(topk_nat), np.asarray(topk_full))
    np.testing.assert_allclose(
        np.asarray(emb_nat), np.asarray(emb_full), atol=1e-6
    )
    np.testing.assert_allclose(float(t_nat), float(t_full))

    # the labels-only hot path returns the native field and identical labels
    topk_lite, emb_lite, _ = model.apply(
        vars_, x, text, mask, 5, method=DepthUNet.predict,
        return_embeddings=False,
    )
    np.testing.assert_array_equal(np.asarray(topk_lite), np.asarray(topk_full))
    assert emb_lite.shape == (2, 16, 16, 32)


def test_hoisted_multinomial_sampler_matches_inline():
    """The train step hoists the multinomial pixel sampler out of the
    grad'd scan (binomial's while_loops re-execute pathologically inside
    scan+grad); hoisted and inline use the same derived key, so losses
    and parameter updates must be bit-identical."""
    import dataclasses

    model = _tiny_model()
    opt = make_optimizer(weight_decay=1e-4)
    cfg = dataclasses.replace(HybridLossConfig(), pixel_sampler="multinomial")

    A, B, H, W, C, D = 2, 2, 32, 32, 20, 32
    key = jax.random.key(1)
    batch = {
        "depth": jax.random.normal(key, (A, B, H, W, 1)),
        "segmentation": jax.random.randint(key, (A, B, H, W), 0, 6),
        "object_label": jnp.ones((A, B), jnp.int32),
        "image_embeddings": jax.random.normal(key, (A, B, D)),
        "sample_valid": jnp.ones((A, B), jnp.float32),
    }
    text = jax.random.normal(jax.random.key(2), (C, D))
    medium = jnp.zeros((C, C), bool)
    hard = jnp.zeros((C, C), bool)

    states, infos = {}, {}
    for hoist in (False, True):
        state = create_train_state(jax.random.key(0), TINY, opt, (1, H, W, 1))
        step = make_train_step(model, opt, cfg, accum_steps=A, donate=False,
                               hoist_sampling=hoist)
        s, info = step(state, batch, jax.random.key(3), jnp.float32(1e-3),
                       jnp.float32(0.25), jnp.float32(0.5), text, medium,
                       hard)
        states[hoist], infos[hoist] = s, info

    for k in ("total_loss", "text_contrastive_loss", "smoothness_loss",
              "image_contrastive_loss"):
        assert float(infos[True][k]) == float(infos[False][k]), k
    deltas = jax.tree.map(
        lambda a, b: float(jnp.abs(a - b).max()),
        states[True].params, states[False].params)
    assert max(jax.tree.leaves(deltas)) == 0.0
