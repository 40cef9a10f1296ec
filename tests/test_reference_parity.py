"""Full-model fp32 parity against the reference implementation.

Imports the reference's torch modules (read-only, as a numerical oracle),
migrates their weights through the framework's torch_interop converter, and
requires the pixel embedding fields to agree at fp32.  This is the
bit-for-bit north-star check: same math, same weights, NHWC vs NCHW only.
"""

import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

REF_ROOT = "/root/reference"
if not os.path.isdir(REF_ROOT):
    pytest.skip("reference repo not mounted", allow_module_level=True)
sys.path.insert(0, REF_ROOT)

from rangeclip.models.depth_unet import DepthUNet, DepthUNetConfig
from rangeclip.models.torch_interop import convert_reference_checkpoint


@pytest.mark.slow
def test_depth_unet_matches_reference_fp32():
    from RangeCLIP.src.depth_segmentation_model.model import DepthUNet as RefDepthUNet

    torch.manual_seed(0)
    ref = RefDepthUNet(
        unet_type="resnet",
        device="cpu",
        n_layer=18,
        input_channels=1,
        encoder_filters=[32, 64, 128, 256, 512],
        embedding_dim=512,
        weight_initializer="kaiming_uniform",
        activation_func="relu",
        use_batch_norm=True,
        use_instance_norm=False,
    )
    ref.eval()

    params, stats = convert_reference_checkpoint(
        {k: v.numpy() for k, v in ref.depth_encoder.state_dict().items()},
        {k: v.numpy() for k, v in ref.depth_decoder.state_dict().items()},
        ref.log_temperature_text.detach().numpy(),
        ref.log_temperature_image.detach().numpy(),
    )
    params = jax.tree.map(jnp.asarray, params)
    stats = jax.tree.map(jnp.asarray, stats)

    cfg = DepthUNetConfig(use_batch_norm=True)
    model = DepthUNet(cfg)
    x = np.random.default_rng(0).standard_normal((1, 64, 64, 1)).astype(np.float32)

    # Structural completeness: converted tree must match the init tree.
    variables = model.init(jax.random.key(0), jnp.asarray(x), train=False)
    assert (
        jax.tree_util.tree_structure(variables["params"])
        == jax.tree_util.tree_structure(params)
    ), "converted param tree structure mismatch"
    assert (
        jax.tree_util.tree_structure(variables["batch_stats"])
        == jax.tree_util.tree_structure(stats)
    ), "converted batch_stats tree structure mismatch"

    with torch.no_grad():
        xt = torch.from_numpy(np.transpose(x, (0, 3, 1, 2)))
        want, want_tt, want_ti = ref(xt)
        want = want.numpy()

    got, got_tt, got_ti = model.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), train=False
    )
    got = np.transpose(np.asarray(got), (0, 3, 1, 2))

    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(got_tt), float(want_tt), rtol=1e-5)
    np.testing.assert_allclose(float(got_ti), float(want_ti), rtol=1e-5)


@pytest.mark.slow
def test_checkpoint_export_roundtrips_into_reference():
    """Our params exported to the reference format strict-load into the
    reference's own torch modules and reproduce our pixel field."""
    from rangeclip.models.torch_interop import (
        convert_reference_checkpoint,
        export_reference_checkpoint,
    )
    from RangeCLIP.src.depth_segmentation_model.model import (
        DepthUNet as RefDepthUNet,
    )

    cfg = DepthUNetConfig(use_batch_norm=True)
    model = DepthUNet(cfg)
    x = np.random.default_rng(1).standard_normal((1, 64, 64, 1)).astype(np.float32)
    variables = model.init(jax.random.key(3), jnp.asarray(x), train=False)

    ckpt = export_reference_checkpoint(
        jax.tree.map(np.asarray, variables["params"]),
        jax.tree.map(np.asarray, variables["batch_stats"]),
        train_step=7,
    )
    assert ckpt["train_step"] == 7

    ref = RefDepthUNet(
        unet_type="resnet", device="cpu", n_layer=18, input_channels=1,
        encoder_filters=[32, 64, 128, 256, 512], embedding_dim=512,
        weight_initializer="kaiming_uniform", activation_func="relu",
        use_batch_norm=True, use_instance_norm=False,
    )
    ref.depth_encoder.load_state_dict(
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in ckpt["encoder"].items()},
        strict=True,
    )
    ref.depth_decoder.load_state_dict(
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in ckpt["decoder"].items()},
        strict=True,
    )
    ref.eval()

    with torch.no_grad():
        want = ref(torch.from_numpy(np.transpose(x, (0, 3, 1, 2))))[0].numpy()
    got, _, _ = model.apply(variables, jnp.asarray(x), train=False)
    got = np.transpose(np.asarray(got), (0, 3, 1, 2))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    # import of the export reproduces the original trees exactly
    params2, stats2 = convert_reference_checkpoint(
        ckpt["encoder"], ckpt["decoder"],
        ckpt["log_temperature_text"], ckpt["log_temperature_image"],
    )
    for a, b in zip(jax.tree.leaves(variables["params"]),
                    jax.tree.leaves(jax.tree.map(jnp.asarray, params2))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
