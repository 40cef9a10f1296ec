"""MiT (SegFormer-style) encoder variant — the BASELINE.json ViT-backbone
stretch config.  Checks the full-stack contract: decoder compatibility,
predict (native-scoring identity at the MiT's x4 upsample), and the train
step with native-resolution losses (label_upsample=4 path)."""

import numpy as np
import jax
import jax.numpy as jnp

from rangeclip.losses.hybrid import HybridLossConfig
from rangeclip.models.depth_unet import (
    DepthUNet,
    DepthUNetConfig,
    build_candidate_mask,
)
from rangeclip.training.optim import make_optimizer
from rangeclip.training.state import create_train_state
from rangeclip.training.train_step import make_train_step

TINY_MIT = DepthUNetConfig(
    unet_type="mit",
    encoder_filters=(0, 16, 32, 64, 96),  # last 4 become MiT stage dims
    embedding_dim=32,
    use_batch_norm=False,
)


def test_mit_unet_forward_shapes():
    model = DepthUNet(TINY_MIT)
    x = jnp.ones((1, 64, 64, 1))
    variables = model.init(jax.random.key(0), x, train=False)
    emb, tt, ti = model.apply(variables, x, train=False)
    assert emb.shape == (1, 64, 64, 32)
    norms = np.asarray(jnp.linalg.norm(emb, axis=-1))
    np.testing.assert_allclose(norms, 1.0, atol=1e-4)
    assert np.isfinite(np.asarray(emb)).all()


def test_mit_predict_native_scoring_identity():
    """The MiT decoder's native field is H/4 (4 stages at H/4..H/32, 3 skip
    blocks), so predict's native-scoring path nearest-upsamples top-k
    indices x4 — must still be exactly the full-resolution prediction."""
    model = DepthUNet(TINY_MIT)
    x = jax.random.normal(jax.random.key(1), (2, 32, 32, 1))
    vars_ = model.init(jax.random.key(0), x, train=False)
    C = 12
    text = jax.random.normal(jax.random.key(2), (C, 32))
    seg = jax.random.randint(jax.random.key(3), (2, 32, 32), 0, 6)
    mask = build_candidate_mask(jax.random.key(4), seg, C, num_negatives=4)

    topk_full, _, _ = model.apply(
        vars_, x, text, mask, 5, method=DepthUNet.predict, score_native=False
    )
    topk_nat, _, _ = model.apply(
        vars_, x, text, mask, 5, method=DepthUNet.predict, score_native=True
    )
    assert topk_nat.shape == (2, 32, 32, 5)
    np.testing.assert_array_equal(np.asarray(topk_nat), np.asarray(topk_full))


def test_mit_native_loss_train_step_equals_fullres():
    """Native-resolution losses under the MiT's x4 nearest upsample produce
    the same losses and parameter updates as the full-resolution step."""
    model = DepthUNet(TINY_MIT)
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
        state = create_train_state(jax.random.key(0), TINY_MIT, opt, (1, H, W, 1))
        step = make_train_step(model, opt, HybridLossConfig(), accum_steps=A,
                               donate=False, native_losses=mode)
        s, info = step(state, batch, jax.random.key(3), jnp.float32(1e-3),
                       jnp.float32(0.25), jnp.float32(0.5), text, medium, hard)
        states[mode], infos[mode] = s, info

    assert np.isfinite(float(infos[True]["total_loss"]))
    for k in ("total_loss", "text_contrastive_loss", "smoothness_loss",
              "image_contrastive_loss"):
        np.testing.assert_allclose(float(infos[True][k]),
                                   float(infos[False][k]), rtol=1e-4,
                                   err_msg=k)
    deltas = jax.tree.map(
        lambda a, b: float(jnp.abs(a - b).max()),
        states[True].params, states[False].params)
    assert max(jax.tree.leaves(deltas)) < 1e-4
