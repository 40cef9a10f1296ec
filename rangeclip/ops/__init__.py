"""Primitive NN op layer (L0).

JAX equivalents of the reference op library
(``utils/src/net_utils.py``): conv/deconv/FC wrappers with selectable weight
init, an activation factory, ResNet/VGG blocks, atrous convolutions and
pyramid pooling, plus torch-semantics-compatible resize primitives.
"""

from rangeclip.ops.activations import activation_func
from rangeclip.ops.initializers import (
    conv_kernel_init,
    conv_transpose_kernel_init,
    dense_kernel_init,
    torch_default_bias_init,
)
from rangeclip.ops.resize import (
    resize_nearest,
    resize_bilinear_align_corners,
    resize_bilinear,
)
from rangeclip.ops.blocks import (
    Conv2d,
    DepthwiseSeparableConv2d,
    AtrousConv2d,
    TransposeConv2d,
    UpConv2d,
    FullyConnected,
    ResNetBlock,
    ResNetBottleneckBlock,
    AtrousResNetBlock,
    VGGNetBlock,
    AtrousVGGNetBlock,
    AtrousSpatialPyramidPooling,
    SpatialPyramidPooling,
    DecoderBlock,
)
from rangeclip.ops.aspp import ASPP

__all__ = [
    "activation_func",
    "conv_kernel_init",
    "conv_transpose_kernel_init",
    "dense_kernel_init",
    "torch_default_bias_init",
    "resize_nearest",
    "resize_bilinear_align_corners",
    "resize_bilinear",
    "Conv2d",
    "DepthwiseSeparableConv2d",
    "AtrousConv2d",
    "TransposeConv2d",
    "UpConv2d",
    "FullyConnected",
    "ResNetBlock",
    "ResNetBottleneckBlock",
    "AtrousResNetBlock",
    "VGGNetBlock",
    "AtrousVGGNetBlock",
    "AtrousSpatialPyramidPooling",
    "SpatialPyramidPooling",
    "DecoderBlock",
    "ASPP",
]
