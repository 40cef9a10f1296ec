"""Embedding providers: real CLIP towers or deterministic hash stubs.

The trainer/validator only need two callables:
  * text:  list[str] labels -> [C, D] float32 table (precomputed once,
    replicated across devices — the reference's rank-0 broadcast,
    train_util.py:198-240, is just replicated sharding in JAX);
  * image: [B, 224, 224, 3] CLIP-normalized crops -> [B, D] features.

``CLIP*Embedder`` wrap the native towers with imported HF weights.
``Hash*Embedder`` are documented test stubs for weightless environments:
deterministic pseudo-embeddings (fixed random projection keyed by content)
that keep every code path — contrast tables, area-image loss, validation —
runnable end-to-end without network access.  They are NOT CLIP and say so.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Protocol, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from rangeclip.models.clip.model import (
    CLIP_VIT_B32,
    CLIPConfig,
    CLIPTextTower,
    CLIPVisionTower,
)


class TextEmbeddingProvider(Protocol):
    dim: int

    def __call__(self, labels: Sequence[str]) -> np.ndarray: ...


class ImageEmbeddingProvider(Protocol):
    dim: int

    def __call__(self, crops: jax.Array) -> jax.Array: ...


class CLIPTextEmbedder:
    """Batched frozen text-embedding precompute (train_util.py:203-226)."""

    def __init__(self, params, tokenizer, config: CLIPConfig = CLIP_VIT_B32,
                 batch_size: int = 128):
        self.tower = CLIPTextTower(config)
        self.params = params
        self.tokenizer = tokenizer
        self.dim = config.projection_dim
        self.batch_size = batch_size
        self._apply = jax.jit(lambda p, ids: self.tower.apply({"params": p}, ids))

    def __call__(self, labels: Sequence[str]) -> np.ndarray:
        outs = []
        for i in range(0, len(labels), self.batch_size):
            chunk = list(labels[i : i + self.batch_size])
            # pad the final chunk so the jit sees one shape
            n_real = len(chunk)
            chunk += [chunk[-1]] * (self.batch_size - n_real)
            ids = jnp.asarray(self.tokenizer(chunk))
            outs.append(np.asarray(self._apply(self.params, ids))[:n_real])
        return np.concatenate(outs, axis=0).astype(np.float32)


class CLIPImageEmbedder:
    """Frozen image tower on prepared crops (dataloader.py:274-284)."""

    def __init__(self, params, config: CLIPConfig = CLIP_VIT_B32):
        self.tower = CLIPVisionTower(config)
        self.params = params
        self.dim = config.projection_dim
        self._apply = jax.jit(lambda p, x: self.tower.apply({"params": p}, x))

    def __call__(self, crops: jax.Array) -> jax.Array:
        return self._apply(self.params, crops)


class HashTextEmbedder:
    """Deterministic pseudo-embeddings from label strings (TEST STUB)."""

    def __init__(self, dim: int = 512, seed: int = 0):
        self.dim = dim
        self.seed = seed

    def __call__(self, labels: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(labels), self.dim), np.float32)
        for i, label in enumerate(labels):
            digest = hashlib.sha256(f"{self.seed}:{label}".encode()).digest()
            rng = np.random.default_rng(np.frombuffer(digest[:8], np.uint64)[0])
            v = rng.standard_normal(self.dim).astype(np.float32)
            out[i] = v / np.linalg.norm(v)
        return out


class HashImageEmbedder:
    """Deterministic pseudo-embeddings from crop content (TEST STUB):
    a fixed random projection of the 8x8-average-pooled crop."""

    def __init__(self, dim: int = 512, seed: int = 0):
        self.dim = dim
        key = jax.random.key(seed)
        self._proj = jax.random.normal(key, (8 * 8 * 3, dim), jnp.float32) / np.sqrt(
            8 * 8 * 3
        )

        def embed(crops: jax.Array) -> jax.Array:
            B, H, W, C = crops.shape
            pooled = crops.reshape(B, 8, H // 8, 8, W // 8, C).mean((2, 4))
            return pooled.reshape(B, -1) @ self._proj

        self._embed = jax.jit(embed)

    def __call__(self, crops: jax.Array) -> jax.Array:
        return self._embed(crops)


# One-deep conversion cache: the trainer builds the text AND image
# providers from the same checkpoint back-to-back, and the conversion
# re-reads the multi-hundred-MB HF file and converts BOTH towers each
# call — cache the last (path, config) result so startup loads it once.
_convert_cache: dict = {}


def _converted_checkpoint(checkpoint_path: str, config: CLIPConfig):
    import os

    from rangeclip.models.clip.convert import convert_clip_checkpoint

    key = (os.path.abspath(checkpoint_path), repr(config))
    if key not in _convert_cache:
        _convert_cache.clear()  # bound memory: one converted model max
        _convert_cache[key] = convert_clip_checkpoint(checkpoint_path, config)
    return _convert_cache[key]


def get_text_provider(
    checkpoint_path: Optional[str] = None,
    vocab_path: Optional[str] = None,
    merges_path: Optional[str] = None,
    dim: int = 512,
    config: CLIPConfig = CLIP_VIT_B32,
) -> TextEmbeddingProvider:
    """Real CLIP when checkpoint+vocab are available, hash stub otherwise."""
    if checkpoint_path and vocab_path and merges_path:
        from rangeclip.models.clip.tokenizer import CLIPTokenizer

        text_params, _ = _converted_checkpoint(checkpoint_path, config)
        tokenizer = CLIPTokenizer(vocab_path, merges_path)
        return CLIPTextEmbedder(text_params, tokenizer, config)
    return HashTextEmbedder(dim=dim)


def get_image_provider(
    checkpoint_path: Optional[str] = None,
    dim: Optional[int] = None,
    config: CLIPConfig = CLIP_VIT_B32,
) -> ImageEmbeddingProvider:
    """``checkpoint_path="random"`` builds the REAL ViT-B/32 vision tower
    with randomly initialized weights: full tower cost and code path
    (trainer window tower, crop pipeline) without an HF checkpoint —
    random weights cost the same FLOPs as converted ones.  Used by the
    canonical-scale convergence run and available to any weightless
    environment that wants tower-true timings rather than the hash stub."""
    if checkpoint_path == "random":
        import dataclasses

        # `dim` adapts the DEFAULT ViT-B/32 config to the requested
        # embedding dim (the trainer passes dim=cfg.embedding_dim with no
        # config); an explicitly supplied custom config keeps its own
        # projection_dim — test/tiny configs must not be silently widened.
        if config is CLIP_VIT_B32 and dim is not None \
                and config.projection_dim != dim:
            config = dataclasses.replace(config, projection_dim=dim)
        elif dim is not None and config.projection_dim != dim:
            # Conflicting EXPLICIT arguments must fail loudly: the caller
            # asked for `dim`-wide embeddings but the custom config will
            # produce config.projection_dim-wide ones (advisor r3).  An
            # omitted dim (None) defers to the config.
            raise ValueError(
                f"get_image_provider(checkpoint_path='random'): dim={dim} "
                f"conflicts with the supplied config's projection_dim="
                f"{config.projection_dim}; pass a matching dim (or omit it)"
            )
        tower = CLIPVisionTower(config)
        dummy = jnp.zeros((1, config.image_size, config.image_size, 3),
                          jnp.float32)
        variables = jax.jit(tower.init)(jax.random.key(0), dummy)
        return CLIPImageEmbedder(variables["params"], config)
    if checkpoint_path:
        _, vision_params = _converted_checkpoint(checkpoint_path, config)
        return CLIPImageEmbedder(vision_params, config)
    return HashImageEmbedder(dim=512 if dim is None else dim)
