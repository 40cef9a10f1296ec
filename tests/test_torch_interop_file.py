"""Checkpoint file roundtrip: save_reference_checkpoint -> torch.load ->
load_reference_checkpoint reproduces the state without the reference repo."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from rangeclip.models.depth_unet import DepthUNet, DepthUNetConfig
from rangeclip.models.torch_interop import (
    load_reference_checkpoint,
    save_reference_checkpoint,
)


def test_pth_file_roundtrip(tmp_path):
    cfg = DepthUNetConfig(
        encoder_filters=(8, 16, 16, 16, 32), embedding_dim=32,
        use_batch_norm=True,
    )
    model = DepthUNet(cfg)
    x = jnp.zeros((1, 32, 32, 1))
    variables = model.init(jax.random.key(0), x, train=False)

    path = str(tmp_path / "ckpt.pth")
    save_reference_checkpoint(
        jax.tree.map(np.asarray, variables["params"]),
        jax.tree.map(np.asarray, variables["batch_stats"]),
        path, train_step=11,
    )

    params, stats, step = load_reference_checkpoint(path)
    assert step == 11
    for a, b in zip(jax.tree.leaves(variables["params"]),
                    jax.tree.leaves(jax.tree.map(jnp.asarray, params))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree.leaves(variables["batch_stats"]),
                    jax.tree.leaves(jax.tree.map(jnp.asarray, stats))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
