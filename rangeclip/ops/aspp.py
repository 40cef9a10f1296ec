"""Project-level ASPP with GroupNorm, as used inside the depth encoder.

Reference: utils/src/networks.py:9-50 —
  * parallel branches with dilation rates [1, 6, 12, 18]; rate 1 uses a 1x1
    conv, others 3x3 with padding == dilation; each branch is
    Conv(bias=False) -> GroupNorm(32) -> ReLU;
  * a global-average-pool branch (1x1 conv -> GN -> ReLU) upsampled
    bilinearly with align_corners=True — since the pooled map is 1x1 this is
    a constant broadcast;
  * concat -> 1x1 projection -> GN -> ReLU -> L2 normalization over channels.

torch Conv2d default init (kaiming_uniform with a=sqrt(5)) is reproduced;
GroupNorm uses eps 1e-5 with affine params (torch defaults).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import jax
import jax.numpy as jnp
from rangeclip import nn

from rangeclip.ops.initializers import conv_kernel_init
from rangeclip.ops.resize import resize_bilinear_align_corners
from rangeclip.utils.math import l2_normalize


class ASPP(nn.Module):
    features: int
    dilation_rates: Sequence[int] = (1, 6, 12, 18)
    num_groups: int = 32
    dtype: Optional[Any] = None

    def _conv_gn_relu(self, x, kernel_size, dilation, name):
        in_ch = x.shape[-1]
        p = dilation if kernel_size > 1 else 0
        x = nn.Conv(
            features=self.features,
            kernel_size=(kernel_size, kernel_size),
            padding=[(p, p), (p, p)],
            kernel_dilation=(dilation, dilation),
            use_bias=False,
            kernel_init=conv_kernel_init("kaiming_uniform", in_ch, self.features, kernel_size),
            dtype=self.dtype,
            name=f"{name}_conv",
        )(x)
        x = nn.GroupNorm(
            num_groups=self.num_groups, epsilon=1e-5, dtype=self.dtype, name=f"{name}_gn"
        )(x)
        return jax.nn.relu(x)

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        size = x.shape[1:3]
        branches = []
        for i, rate in enumerate(self.dilation_rates):
            k = 3 if rate > 1 else 1
            branches.append(self._conv_gn_relu(x, k, rate if rate > 1 else 1, f"branch{i}"))

        pooled = jnp.mean(x, axis=(1, 2), keepdims=True)
        pooled = self._conv_gn_relu(pooled, 1, 1, "global_pool")
        branches.append(resize_bilinear_align_corners(pooled, size))

        out = jnp.concatenate(branches, axis=-1)
        out = self._conv_gn_relu(out, 1, 1, "project")
        return l2_normalize(out, axis=-1)
