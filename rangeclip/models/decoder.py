"""UNet depth decoder.

Reference: utils/src/decoder.py:24-117 —
  * one DecoderBlock per entry of ``n_filters`` (the reversed encoder filter
    list); the first block has no skip (:46-57), later blocks concat the
    reversed encoder features excluding the deepest (:98-111);
  * a final 3x3 conv to ``embedding_dim`` with no activation (:75-82);
  * nearest-neighbor upsample to the requested output shape and channel-wise
    L2 normalization (:113-116).

NHWC; the returned pixel-embedding field has shape [B, H, W, D].
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import jax

from rangeclip import nn
from rangeclip.ops.blocks import Conv2d, DecoderBlock
from rangeclip.ops.resize import resize_nearest
from rangeclip.utils.math import l2_normalize


class DepthDecoder(nn.Module):
    n_filters: Sequence[int] = (512, 256, 128, 64, 32)
    embedding_dim: int = 512
    weight_initializer: str = "kaiming_uniform"
    activation: str = "relu"
    use_batch_norm: bool = False
    use_instance_norm: bool = False
    bn_axis_name: Optional[str] = None
    dtype: Optional[Any] = None

    @nn.compact
    def __call__(
        self,
        spatial_feature_map: jax.Array,
        encoder_features: List[jax.Array],
        target_shape: Optional[Tuple[int, int]],
        train: bool = False,
        normalize: bool = True,
        apply_head: bool = True,
    ) -> jax.Array:
        """``target_shape=None`` skips the final nearest upsample and returns
        the field at its native resolution (H/2 — the resolution of the last
        decoder block, reference decoder.py:113 before the interpolate at
        :114).  Because the final upsample is *nearest* and every downstream
        consumer is per-pixel (L2 norm, scoring, top-k), computing on the
        native field and nearest-upsampling the result is exact.

        ``normalize=False`` returns the raw output-conv field for consumers
        that only rank scores per pixel (a positive per-pixel scale cannot
        change the order) — one full read+write of the field saved per skip.

        ``apply_head=False`` stops before the output conv and returns the
        last block's features [B, H/2, W/2, n_filters[-1]] for consumers
        that fold the head into the scoring (depth_unet.predict_folded) —
        the [.., D] field then never exists in memory at all."""
        # Skips are the reversed encoder features minus the deepest one
        # (decoder.py:98): [g3@H/16, g2@H/8, g1@H/4, conv1@H/2] for resnet18.
        skip_features = encoder_features[:-1][::-1]
        assert len(skip_features) == len(self.n_filters) - 1, (
            f"Mismatch in number of skip features and decoder blocks: "
            f"{len(skip_features)} vs {len(self.n_filters) - 1}"
        )

        common = dict(
            weight_initializer=self.weight_initializer,
            activation=self.activation,
            use_batch_norm=self.use_batch_norm,
            use_instance_norm=self.use_instance_norm,
            bn_axis_name=self.bn_axis_name,
            dtype=self.dtype,
        )

        x = DecoderBlock(self.n_filters[0], use_skip=False, name="up_block0", **common)(
            spatial_feature_map, None, train
        )
        for i in range(1, len(self.n_filters)):
            x = DecoderBlock(self.n_filters[i], use_skip=True, name=f"up_block{i}", **common)(
                x, skip_features[i - 1], train
            )
        if not apply_head:
            return x

        x = Conv2d(
            self.embedding_dim,
            kernel_size=3,
            stride=1,
            weight_initializer=self.weight_initializer,
            activation=None,
            dtype=self.dtype,
            name="output_conv",
        )(x, train)

        if target_shape is not None:
            x = resize_nearest(x, target_shape)
        if not normalize:
            return x
        return l2_normalize(x, axis=-1)
