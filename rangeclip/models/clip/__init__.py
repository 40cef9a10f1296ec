"""Frozen CLIP towers (capability dependency of the reference).

The reference consumes HF ``openai/clip-vit-base-patch32`` for (a) the text
tower that embeds candidate labels (train_util.py:198-226), (b) the image
tower that embeds object crops (dataloader.py:274-284), with
``projection_dim`` (512) defining the shared space (train_util.py:127).

Here CLIP is implemented natively on ``rangeclip.nn`` (models/clip/model.py) with an
HF-checkpoint weight importer (models/clip/convert.py), a from-scratch BPE
tokenizer (models/clip/tokenizer.py), and deterministic hash-based embedding
stubs for weightless environments (models/clip/provider.py).
"""

from rangeclip.models.clip.model import (
    CLIPConfig,
    CLIPTextTower,
    CLIPVisionTower,
    CLIP_VIT_B32,
)
from rangeclip.models.clip.provider import (
    TextEmbeddingProvider,
    ImageEmbeddingProvider,
    CLIPTextEmbedder,
    CLIPImageEmbedder,
    HashTextEmbedder,
    HashImageEmbedder,
    get_text_provider,
    get_image_provider,
)
from rangeclip.models.clip.crops import prepare_image_crops, clip_normalize

__all__ = [
    "CLIPConfig",
    "CLIPTextTower",
    "CLIPVisionTower",
    "CLIP_VIT_B32",
    "TextEmbeddingProvider",
    "ImageEmbeddingProvider",
    "CLIPTextEmbedder",
    "CLIPImageEmbedder",
    "HashTextEmbedder",
    "HashImageEmbedder",
    "get_text_provider",
    "get_image_provider",
    "prepare_image_crops",
    "clip_normalize",
]
