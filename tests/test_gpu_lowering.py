"""The production programs lower for the CUDA backend, from a CPU host.

``jax.export`` with ``platforms=("cuda",)`` traces and lowers a program
for the GPU without a GPU present.  Every main-path program — predict in
both formulations, the fp32 and bf16 train steps, the hybrid loss and its
gradient, class-sharded predict and the MiT encoder — must lower, contain
no accelerator-specific custom call of another platform, and produce the
expected result shapes.  (What the GPU compiler then makes of the module
is checked on the card by chip_smoke.py.)
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rangeclip.losses.hybrid import HybridLossConfig, compute_hybrid_loss
from rangeclip.losses.pooling import per_item_masked_pooling
from rangeclip.losses.smoothness import total_variation_loss
from rangeclip.models.depth_unet import (
    DepthUNet,
    DepthUNetConfig,
    build_candidate_indices,
    predict_folded,
)

B, R, C, D, K = 2, 32, 24, 32, 5
FILTERS = (8, 16, 16, 16, 32)


def _cfg(bf16=False, unet="resnet"):
    return DepthUNetConfig(
        unet_type=unet, encoder_filters=FILTERS, embedding_dim=D,
        use_batch_norm=True, dtype=jnp.bfloat16 if bf16 else None)


def _model_inputs(bf16=False, unet="resnet"):
    model = DepthUNet(_cfg(bf16, unet))
    depth = jax.random.normal(jax.random.key(0), (B, R, R, 1))
    variables = model.init(jax.random.key(1), depth, train=False)
    text = jax.random.normal(jax.random.key(2), (C, D))
    return model, variables, depth, text


# custom calls XLA itself understands on every backend: its top-k op and
# the sharding annotations of shard_map / GSPMD
XLA_CUSTOM_CALLS = {"mhlo.topk", "Sharding", "SPMDFullToShardShape",
                    "SPMDShardToFullShape"}


def _export_cuda(fn, *args):
    exported = jax.export.export(jax.jit(fn), platforms=("cuda",))(*args)
    text = exported.mlir_module()
    assert exported.platforms == ("cuda",)
    targets = set(re.findall(r"stablehlo\.custom_call @([\w.$]+)", text))
    assert targets <= XLA_CUSTOM_CALLS, targets - XLA_CUSTOM_CALLS
    return exported, targets


def _predict_folded(bf16):
    model, variables, depth, text = _model_inputs(bf16)
    seg = jax.random.randint(jax.random.key(3), (B, R, R), 0, 8)
    cand = build_candidate_indices(jax.random.key(4), seg, C, 6, capacity=16)
    return (lambda v, d: predict_folded(model, v, d, text, top_k=K,
                                        candidate_indices=cand),
            (variables, depth), [(B, R, R, K)])


def _predict_default(bf16):
    model, variables, depth, text = _model_inputs(bf16)
    mask = jnp.arange(C) % 3 != 0
    return (lambda v, d: model.apply(v, d, text, mask, K,
                                     method=DepthUNet.predict)[0],
            (variables, depth), [(B, R, R, K)])


def _train_step(bf16):
    from rangeclip.training.optim import make_optimizer
    from rangeclip.training.state import create_train_state
    from rangeclip.training.train_step import make_train_step

    cfg = _cfg(bf16)
    opt = make_optimizer(1e-4)
    state = create_train_state(jax.random.key(0), cfg, opt, (B, R, R, 1))
    rng = np.random.default_rng(0)
    batch = {
        "depth": rng.standard_normal((1, B, R, R, 1)).astype(np.float32),
        "segmentation": rng.integers(0, 8, (1, B, R, R)).astype(np.int32),
        "object_label": np.ones((1, B), np.int32),
        "image_embeddings": rng.standard_normal((1, B, D)).astype(np.float32),
        "sample_valid": np.ones((1, B), np.float32),
    }
    text = rng.standard_normal((C, D)).astype(np.float32)
    med = np.zeros((C, C), bool)
    step = make_train_step(DepthUNet(cfg), opt, HybridLossConfig(),
                           accum_steps=1, donate=False)

    def fn(state, batch):
        new_state, info = step(state, batch, jax.random.key(5),
                               jnp.float32(1e-4), jnp.float32(0.25),
                               jnp.float32(0.5), text, med, med)
        return new_state.step, info["total_loss"]

    return fn, (state, batch), [(), ()]


def _loss_inputs(bf16):
    h = R // 2
    dt = jnp.bfloat16 if bf16 else jnp.float32
    field = jax.random.normal(jax.random.key(6), (B, h, h, D)).astype(dt)
    seg = jax.random.randint(jax.random.key(7), (B, R, R), 0, 8)
    text = jax.random.normal(jax.random.key(8), (C, D))
    med = jnp.zeros((C, C), bool)
    area = jax.random.normal(jax.random.key(9), (B, D))
    return field, seg, text, med, area


def _hybrid_loss(grad, bf16=False):
    field, seg, text, med, area = _loss_inputs(bf16)

    def loss(field, area):
        return compute_hybrid_loss(
            jax.random.key(10), field, seg, text, med, med,
            jnp.float32(0.07), jnp.float32(0.1), 0.25, 0.5,
            area_embeddings=area, image_embeddings=area,
            label_upsample=2)[0]

    if grad:
        return (jax.grad(loss, argnums=(0, 1)), (field, area),
                [field.shape, area.shape])
    return loss, (field, area), [()]


def _pool_tv_grads():
    field, seg, _, _, _ = _loss_inputs(False)

    def f(field):
        pooled = per_item_masked_pooling(field, seg, seg[:, 0, 0], upsample=2)
        return jnp.sum(pooled) + total_variation_loss(field, upsample=2)

    return jax.grad(f), (field,), [field.shape]


def _sharded_predict():
    from rangeclip.parallel.mesh import make_mesh
    from rangeclip.parallel.predict import (
        make_sharded_predict,
        pad_class_table,
    )

    model, variables, depth, text = _model_inputs()
    mesh = make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    table, ids = pad_class_table(text, 2)
    fn = make_sharded_predict(model, mesh, top_k=K, predict_path="default")
    return fn, (variables, depth, table, ids), [(B, R, R, K)]


def _mit_forward(bf16):
    model, variables, depth, _ = _model_inputs(bf16, unet="mit")
    return (lambda v, d: model.apply(v, d)[0], (variables, depth),
            [(B, R, R, D)])


def _train_forward():
    model, variables, depth, _ = _model_inputs()
    return (lambda v, d: model.apply(v, d, train=True,
                                     mutable=["batch_stats"])[0][0],
            (variables, depth), [(B, R, R, D)])


CASES = {
    "predict_folded_fp32": lambda: _predict_folded(False),
    "predict_folded_bf16": lambda: _predict_folded(True),
    "predict_default_fp32": lambda: _predict_default(False),
    "predict_default_bf16": lambda: _predict_default(True),
    "train_step_fp32": lambda: _train_step(False),
    "train_step_bf16": lambda: _train_step(True),
    "hybrid_loss_fwd": lambda: _hybrid_loss(grad=False),
    "hybrid_loss_bwd_fp32": lambda: _hybrid_loss(grad=True),
    "hybrid_loss_bwd_bf16": lambda: _hybrid_loss(grad=True, bf16=True),
    "pooling_tv_bwd": _pool_tv_grads,
    "sharded_predict_data2_model2": _sharded_predict,
    "mit_forward_fp32": lambda: _mit_forward(False),
    "mit_forward_bf16": lambda: _mit_forward(True),
    "train_mode_forward": _train_forward,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_main_path_lowers_for_cuda(case):
    fn, args, shapes = CASES[case]()
    exported, targets = _export_cuda(fn, *args)
    assert [tuple(a.shape) for a in exported.out_avals] == [
        tuple(s) for s in shapes]
    if case.startswith(("predict", "sharded")):
        # selection is XLA's own top-k
        assert "mhlo.topk" in targets
