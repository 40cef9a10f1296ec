"""Block-level parity vs torch oracles built from torch primitives.

Strategy: construct the torch layer as documented in SURVEY.md section 2.1,
copy its weights into our module, and require fp32 agreement.
"""

import numpy as np
import torch
import torch.nn as tnn
import jax
import jax.numpy as jnp

from rangeclip.ops.blocks import (
    Conv2d,
    TransposeConv2d,
    DecoderBlock,
    ResNetBlock,
)


def nhwc(x):
    return np.transpose(x, (0, 2, 3, 1))


def t2f_conv(w):  # torch [out,in,kh,kw] -> HWIO
    return np.transpose(w.detach().numpy(), (2, 3, 1, 0))


def t2f_convT(w):  # torch [in,out,kh,kw] -> ours (kh,kw,in,out)
    return np.transpose(w.detach().numpy(), (2, 3, 0, 1))


def test_conv2d_bn_relu_matches_torch():
    torch.manual_seed(0)
    x = torch.randn(2, 5, 13, 13)
    conv = tnn.Conv2d(5, 8, 3, stride=2, padding=1, bias=False)
    bn = tnn.BatchNorm2d(8)
    bn.train()
    conv.train()
    want = torch.relu(bn(conv(x))).detach().numpy()

    mod = Conv2d(features=8, kernel_size=3, stride=2, activation="relu",
                 use_batch_norm=True)
    variables = mod.init(jax.random.key(0), jnp.asarray(nhwc(x.numpy())), train=True)
    variables = {
        "params": {
            "conv": {"kernel": t2f_conv(conv.weight)},
            "norm_act": {"batch_norm": {
                "scale": bn.weight.detach().numpy(),
                "bias": bn.bias.detach().numpy(),
            }},
        },
        "batch_stats": variables["batch_stats"],
    }
    got, _ = mod.apply(
        variables, jnp.asarray(nhwc(x.numpy())), train=True, mutable=["batch_stats"]
    )
    np.testing.assert_allclose(np.asarray(got), nhwc(want), rtol=1e-4, atol=1e-5)


def test_transpose_conv2d_matches_torch():
    torch.manual_seed(1)
    x = torch.randn(2, 4, 9, 9)
    deconv = tnn.ConvTranspose2d(4, 6, 3, stride=2, padding=1, output_padding=1,
                                 bias=False)
    want = torch.relu(deconv(x)).detach().numpy()
    assert want.shape[2:] == (18, 18)

    mod = TransposeConv2d(features=6, kernel_size=3, activation="relu")
    variables = mod.init(jax.random.key(0), jnp.asarray(nhwc(x.numpy())))
    variables = {"params": {"kernel": t2f_convT(deconv.weight),
                            "norm_act": variables["params"].get("norm_act", {})}}
    got = mod.apply(variables, jnp.asarray(nhwc(x.numpy())))
    np.testing.assert_allclose(np.asarray(got), nhwc(want), rtol=1e-4, atol=1e-5)


def test_decoder_block_upsample_matches_torch():
    """DecoderBlock's upsampler: ConvTranspose2d(k2, s2, bias=True)."""
    torch.manual_seed(2)
    x = torch.randn(1, 4, 7, 7)
    skip = torch.randn(1, 3, 14, 14)
    deconv = tnn.ConvTranspose2d(4, 6, 2, stride=2)
    conv1 = tnn.Conv2d(6 + 3, 6, 3, padding=1, bias=False)
    conv2 = tnn.Conv2d(6, 6, 3, padding=1, bias=False)
    up = deconv(x)
    cat = torch.cat([up, skip], dim=1)
    want = torch.relu(conv2(torch.relu(conv1(cat)))).detach().numpy()

    mod = DecoderBlock(features=6, activation="relu", use_skip=True)
    xs, ss = jnp.asarray(nhwc(x.numpy())), jnp.asarray(nhwc(skip.numpy()))
    variables = mod.init(jax.random.key(0), xs, ss)
    params = {
        "upsample_kernel": t2f_convT(deconv.weight),
        "upsample_bias": deconv.bias.detach().numpy(),
        "conv1": {"conv": {"kernel": t2f_conv(conv1.weight)},
                  "norm_act": variables["params"]["conv1"].get("norm_act", {})},
        "conv2": {"conv": {"kernel": t2f_conv(conv2.weight)},
                  "norm_act": variables["params"]["conv2"].get("norm_act", {})},
    }
    got = mod.apply({"params": params}, xs, ss)
    np.testing.assert_allclose(np.asarray(got), nhwc(want), rtol=1e-4, atol=1e-5)


def test_resnet_block_projection_logic():
    """Identity branch must skip projection when shapes match (and use it
    otherwise) — net_utils.py:658-668 semantics."""
    x = jnp.ones((1, 8, 8, 16))

    same = ResNetBlock(features=16, stride=1, activation="relu")
    v = same.init(jax.random.key(0), x)
    assert "projection" not in v["params"]

    diff = ResNetBlock(features=32, stride=2, activation="relu")
    v = diff.init(jax.random.key(0), x)
    assert "projection" in v["params"]
    out = diff.apply(v, x)
    assert out.shape == (1, 4, 4, 32)


def test_default_init_distribution_matches_torch_default():
    """kaiming_uniform (torch default) -> bound = 1/sqrt(fan_in)."""
    mod = Conv2d(features=64, kernel_size=3, activation=None)
    v = mod.init(jax.random.key(0), jnp.ones((1, 8, 8, 32)))
    k = np.asarray(v["params"]["conv"]["kernel"])
    bound = 1.0 / np.sqrt(32 * 9)
    assert k.min() >= -bound and k.max() <= bound
    assert k.std() > bound / 3  # roughly uniform, not degenerate
