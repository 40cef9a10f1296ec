"""Checkpoints as one .npz per step: round trips, template-free weight
restore, retention, and the errors a mismatched template gets."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from rangeclip.models.depth_unet import DepthUNetConfig
from rangeclip.parallel.mesh import make_mesh, replicate
from rangeclip.training.checkpoint import CheckpointManager
from rangeclip.training.optim import make_optimizer
from rangeclip.training.state import create_train_state

CFG = DepthUNetConfig(encoder_filters=(8, 16, 16, 16, 32), embedding_dim=32,
                      use_batch_norm=True)


def _state(seed=0, step=3):
    opt = make_optimizer(weight_decay=1e-4)
    state = create_train_state(jax.random.key(seed), CFG, opt, (1, 32, 32, 1))
    return state.replace(step=jnp.int32(step))


def test_roundtrip_restores_values_dtypes_and_template_sharding(tmp_path):
    state = _state()
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(state)
    assert os.path.exists(tmp_path / "ck" / "3" / "state.npz")
    mesh = make_mesh(n_data=2)
    template = replicate(mesh, _state(seed=1, step=0))
    back = mgr.restore(template)
    assert int(back.step) == 3
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    leaf = jax.tree.leaves(back.params)[0]
    assert leaf.sharding == NamedSharding(mesh, P())


def test_weights_restore_is_template_free_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3):
        mgr.save(_state(step=step))
    assert mgr.steps() == [2, 3] and mgr.latest_step() == 3
    params, stats, step = mgr.restore_weights()
    assert step == 3
    want = _state().params
    assert jax.tree_util.tree_structure(params) == \
        jax.tree_util.tree_structure(want)
    assert set(stats) == {"depth_decoder", "depth_encoder"}
    enc_params, _ = mgr.restore_encoder_params(_state(seed=5))
    np.testing.assert_array_equal(
        np.asarray(jax.tree.leaves(enc_params["depth_encoder"])[0]),
        np.asarray(jax.tree.leaves(want["depth_encoder"])[0]))


def test_restore_rejects_mismatched_templates(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mgr.restore(_state())
    mgr.save(_state())
    other = DepthUNetConfig(encoder_filters=(8, 16, 16, 16, 64),
                            embedding_dim=32, use_batch_norm=True)
    opt = make_optimizer(weight_decay=1e-4)
    wide = create_train_state(jax.random.key(0), other, opt, (1, 32, 32, 1))
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(wide)
    plain = create_train_state(jax.random.key(0), CFG, make_optimizer(),
                               (1, 32, 32, 1))
    with pytest.raises(KeyError):
        CheckpointManager(str(tmp_path)).restore(plain.replace(
            opt_state=(plain.opt_state, plain.opt_state)))
