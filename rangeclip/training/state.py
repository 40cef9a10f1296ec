"""Train state pytree.

Replaces the reference's mutable nn.Module + torch checkpoint dict
(model.py:368-393) with an immutable pytree dataclass holding everything a
step needs: params (including the learnable log-temperatures), BN
batch_stats, optimizer state, and the step counter.  training/checkpoint.py
serializes it leaf by leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import optax

from rangeclip.models.depth_unet import DepthUNet, DepthUNetConfig


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrainState:
    step: jax.Array  # int32 scalar
    params: Any
    batch_stats: Any
    opt_state: Any

    def replace(self, **updates) -> "TrainState":
        return dataclasses.replace(self, **updates)


def create_train_state(
    rng: jax.Array,
    config: DepthUNetConfig,
    optimizer: optax.GradientTransformation,
    input_shape=(1, 224, 224, 1),
) -> TrainState:
    model = DepthUNet(config)
    # jitted init: eager init dispatches hundreds of tiny ops one by one;
    # compiled it is one program
    variables = jax.jit(
        lambda key: model.init(key, jnp.zeros(input_shape, jnp.float32), train=True)
    )(rng)
    params = variables["params"]
    batch_stats = variables.get("batch_stats", {})
    opt_state = optimizer.init(params)
    return TrainState(
        step=jnp.int32(0),
        params=params,
        batch_stats=batch_stats,
        opt_state=opt_state,
    )
