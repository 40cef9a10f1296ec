"""Network modules (L1) and model wrappers (L2)."""

from rangeclip.models.encoder import DepthEncoder
from rangeclip.models.decoder import DepthDecoder
from rangeclip.models.depth_unet import DepthUNet, DepthUNetConfig

__all__ = ["DepthEncoder", "DepthDecoder", "DepthUNet", "DepthUNetConfig"]
