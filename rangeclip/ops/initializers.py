"""Weight-initializer registry with torch-compatible semantics.

The reference op library selects one of {kaiming_normal, kaiming_uniform,
xavier_normal, xavier_uniform} per layer (``utils/src/net_utils.py:96-105``),
where ``kaiming_uniform`` means "leave torch's default init in place".  To
reproduce the same weight distributions at fp32 we implement the torch
formulas explicitly for HWIO kernel layouts:

  * torch default conv/linear init ("kaiming_uniform" here):
    U(-b, b) with b = sqrt(6 / ((1 + a^2) * fan_in)) and a = sqrt(5),
    i.e. b = 1 / sqrt(fan_in).
  * ``kaiming_normal_`` (torch defaults fan_in, leaky_relu a=0):
    N(0, sqrt(2 / fan_in)).
  * ``xavier_normal_``: N(0, sqrt(2 / (fan_in + fan_out))).
  * ``xavier_uniform_``: U(-b, b), b = sqrt(6 / (fan_in + fan_out)).
  * torch default bias init: U(-1/sqrt(fan_in), 1/sqrt(fan_in)).

fan_in/fan_out follow torch's convention on the *torch* weight layout:
  conv [out, in, kh, kw]        -> fan_in = in*kh*kw,  fan_out = out*kh*kw
  conv-transpose [in, out, kh, kw] -> fan_in = out*kh*kw, fan_out = in*kh*kw
  linear [out, in]              -> fan_in = in,        fan_out = out

Conv and conv-transpose kernels are stored as HWIO, dense kernels as
[in, out]; the factories below
take the fan values computed from the *logical* layer geometry, so layout
differences cannot corrupt the fan computation.
"""

from __future__ import annotations

import math
from typing import Callable

import jax
import jax.numpy as jnp

Initializer = Callable[..., jax.Array]

_VALID = ("kaiming_uniform", "kaiming_normal", "xavier_normal", "xavier_uniform")


def _make_init(name: str, fan_in: int, fan_out: int) -> Initializer:
    if name == "kaiming_uniform":
        # torch default: kaiming_uniform with a=sqrt(5) -> bound = 1/sqrt(fan_in)
        bound = 1.0 / math.sqrt(fan_in)

        def init(key, shape, dtype=jnp.float32):
            return jax.random.uniform(key, shape, dtype, -bound, bound)

    elif name == "kaiming_normal":
        std = math.sqrt(2.0 / fan_in)

        def init(key, shape, dtype=jnp.float32):
            return std * jax.random.normal(key, shape, dtype)

    elif name == "xavier_normal":
        std = math.sqrt(2.0 / (fan_in + fan_out))

        def init(key, shape, dtype=jnp.float32):
            return std * jax.random.normal(key, shape, dtype)

    elif name == "xavier_uniform":
        bound = math.sqrt(6.0 / (fan_in + fan_out))

        def init(key, shape, dtype=jnp.float32):
            return jax.random.uniform(key, shape, dtype, -bound, bound)

    else:
        raise ValueError(
            f"Unsupported weight initializer: {name!r} (expected one of {_VALID})"
        )

    return init


def conv_kernel_init(
    name: str, in_channels: int, out_channels: int, kernel_size: int,
    groups: int = 1,
) -> Initializer:
    """Initializer for a conv kernel with torch fan conventions.

    For grouped convs torch computes fan_in from the per-group input channels
    (weight shape [out, in/groups, kh, kw]).
    """
    k2 = kernel_size * kernel_size
    fan_in = (in_channels // groups) * k2
    fan_out = (out_channels // groups) * k2
    return _make_init(name, fan_in, fan_out)


def conv_transpose_kernel_init(
    name: str, in_channels: int, out_channels: int, kernel_size: int
) -> Initializer:
    """Initializer for a conv-transpose kernel.

    torch's ConvTranspose2d weight is [in, out, kh, kw] so fan_in/fan_out are
    swapped relative to a regular conv.
    """
    k2 = kernel_size * kernel_size
    fan_in = out_channels * k2
    fan_out = in_channels * k2
    return _make_init(name, fan_in, fan_out)


def dense_kernel_init(name: str, in_features: int, out_features: int) -> Initializer:
    return _make_init(name, in_features, out_features)


def torch_default_bias_init(fan_in: int) -> Initializer:
    """torch's default bias init for conv/linear: U(-1/sqrt(fan_in), +...)."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0

    def init(key, shape, dtype=jnp.float32):
        return jax.random.uniform(key, shape, dtype, -bound, bound)

    return init
