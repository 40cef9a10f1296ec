"""ResNet-style depth encoder.

Reference: utils/src/encoder.py:29-126 —
  * 7x7 stride-2 conv on the 1-channel depth map (:59-67);
  * 3x3 stride-2 max pool (:69);
  * four ResNet block groups built from ``n_filters[1:]`` / ``n_blocks``
    (:72-90); groups 2-4 stride 2 on their first block; resnet 18/34 use the
    basic block, 50 the bottleneck (4x expansion);
  * a global-average-pool + 2-layer MLP projection head producing an
    L2-normalized global embedding (:92-99,120-122) — returned for API parity
    though unused by the segmentation path;
  * ASPP applied to the final feature map (:101,124).

Returns ``(embedding, features, aspp_feature_map)`` where ``features`` is the
5-entry skip list [conv1@H/2, g1@H/4, g2@H/8, g3@H/16, g4@H/32] (NHWC).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from rangeclip import nn

from rangeclip.ops.aspp import ASPP
from rangeclip.ops.blocks import Conv2d, ResNetBlock, ResNetBottleneckBlock
from rangeclip.ops.initializers import dense_kernel_init, torch_default_bias_init
from rangeclip.utils.math import l2_normalize


class DepthEncoder(nn.Module):
    n_layer: int = 18
    n_filters: Sequence[int] = (32, 64, 128, 256, 512)
    embedding_dim: int = 512
    weight_initializer: str = "kaiming_uniform"
    activation: str = "relu"
    use_batch_norm: bool = False
    use_instance_norm: bool = False
    bn_axis_name: Optional[str] = None
    dtype: Optional[Any] = None

    @nn.compact
    def __call__(
        self, x: jax.Array, train: bool = False
    ) -> Tuple[jax.Array, List[jax.Array], jax.Array]:
        if x.ndim == 3:  # [B, H, W] -> [B, H, W, 1]
            x = x[..., None]

        if self.n_layer == 18:
            n_blocks, block_cls, expansion = [2, 2, 2, 2], ResNetBlock, 1
        elif self.n_layer == 34:
            n_blocks, block_cls, expansion = [3, 4, 6, 3], ResNetBlock, 1
        elif self.n_layer == 50:
            n_blocks, block_cls, expansion = [3, 4, 6, 3], ResNetBottleneckBlock, 4
        else:
            raise ValueError("Only supports 18, 34, 50 layer architecture")

        common = dict(
            weight_initializer=self.weight_initializer,
            activation=self.activation,
            use_batch_norm=self.use_batch_norm,
            use_instance_norm=self.use_instance_norm,
            bn_axis_name=self.bn_axis_name,
            dtype=self.dtype,
        )

        features: List[jax.Array] = []
        x = Conv2d(self.n_filters[0], kernel_size=7, stride=2, name="conv1", **common)(
            x, train
        )
        features.append(x)

        x = nn.max_pool(x, (3, 3), strides=(2, 2), padding=[(1, 1), (1, 1)])

        for i, (n_filter, n_block) in enumerate(zip(self.n_filters[1:], n_blocks), 1):
            for j in range(n_block):
                stride = 2 if (j == 0 and i > 1) else 1
                x = block_cls(
                    features=n_filter,
                    stride=stride,
                    name=f"group{i}_block{j}",
                    **common,
                )(x, train)
            features.append(x)

        final_channels = self.n_filters[-1] * expansion

        pooled = jnp.mean(x, axis=(1, 2))  # global average pool -> [B, C]
        h = nn.Dense(
            final_channels,
            kernel_init=dense_kernel_init("kaiming_uniform", final_channels, final_channels),
            bias_init=torch_default_bias_init(final_channels),
            dtype=self.dtype,
            name="projection_head_fc1",
        )(pooled)
        h = jax.nn.relu(h)
        h = nn.Dense(
            self.embedding_dim,
            kernel_init=dense_kernel_init("kaiming_uniform", final_channels, self.embedding_dim),
            bias_init=torch_default_bias_init(final_channels),
            dtype=self.dtype,
            name="projection_head_fc2",
        )(h)
        embedding = l2_normalize(h, axis=-1)

        aspp_map = ASPP(features=self.embedding_dim, dtype=self.dtype, name="aspp")(x)

        return embedding, features, aspp_map
