"""Native CLIP towers vs HF transformers (randomly initialized tiny config —
no network).  Converted weights must reproduce get_text_features /
get_image_features numerics."""

import numpy as np
import pytest
import jax.numpy as jnp

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

from rangeclip.models.clip.convert import convert_text_tower, convert_vision_tower
from rangeclip.models.clip.model import CLIPConfig, CLIPTextTower, CLIPVisionTower

TINY_KW = dict(
    vocab_size=99,
    max_position_embeddings=16,
    text_width=32,
    text_heads=4,
    text_layers=2,
    image_size=32,
    patch_size=8,
    vision_width=48,
    vision_heads=4,
    vision_layers=2,
    projection_dim=24,
)


def _tiny_hf_model():
    cfg = transformers.CLIPConfig(
        text_config=dict(
            vocab_size=TINY_KW["vocab_size"],
            max_position_embeddings=TINY_KW["max_position_embeddings"],
            hidden_size=TINY_KW["text_width"],
            num_attention_heads=TINY_KW["text_heads"],
            num_hidden_layers=TINY_KW["text_layers"],
            intermediate_size=4 * TINY_KW["text_width"],
            hidden_act="quick_gelu",
            # real CLIP's EOT (49407) is the vocab's highest id; mirror that
            # so HF's eos-position pooling and our argmax pooling coincide
            bos_token_id=97,
            eos_token_id=98,
        ),
        vision_config=dict(
            image_size=TINY_KW["image_size"],
            patch_size=TINY_KW["patch_size"],
            hidden_size=TINY_KW["vision_width"],
            num_attention_heads=TINY_KW["vision_heads"],
            num_hidden_layers=TINY_KW["vision_layers"],
            intermediate_size=4 * TINY_KW["vision_width"],
            hidden_act="quick_gelu",
        ),
        projection_dim=TINY_KW["projection_dim"],
    )
    torch.manual_seed(0)
    model = transformers.CLIPModel(cfg)
    model.eval()
    return model


def test_text_tower_matches_hf():
    hf = _tiny_hf_model()
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    cfg = CLIPConfig(**TINY_KW)
    params = convert_text_tower(sd, cfg)

    rng = np.random.default_rng(0)
    ids = np.zeros((3, 12), np.int64)
    for b in range(3):
        n = rng.integers(3, 10)
        ids[b, 0] = 97  # pretend SOT
        ids[b, 1:n] = rng.integers(1, 90, n - 1)
        ids[b, n] = 98  # EOT = highest id used
    with torch.no_grad():
        want = hf.get_text_features(
            input_ids=torch.from_numpy(ids),
            attention_mask=torch.ones_like(torch.from_numpy(ids)),
        ).numpy()

    got = np.asarray(CLIPTextTower(cfg).apply({"params": params},
                                              jnp.asarray(ids, jnp.int32)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_vision_tower_matches_hf():
    hf = _tiny_hf_model()
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    cfg = CLIPConfig(**TINY_KW)
    params = convert_vision_tower(sd, cfg)

    rng = np.random.default_rng(1)
    pix = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    with torch.no_grad():
        want = hf.get_image_features(pixel_values=torch.from_numpy(pix)).numpy()

    nhwc = jnp.asarray(np.transpose(pix, (0, 2, 3, 1)))
    got = np.asarray(CLIPVisionTower(cfg).apply({"params": params}, nhwc))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_tokenizer_matches_hf_on_unicode(tmp_path):
    """BPE tokenizer vs HF's CLIPTokenizer on the same (tiny, merge-free)
    vocab: unicode letters must stay inside words ('café' — CLIP's \\p{L}+,
    which the previous ASCII-only regex split at the accent), underscores
    tokenize as punctuation, contractions and digits split per the CLIP
    pattern."""
    import json

    from transformers import CLIPTokenizer as HFTok

    from rangeclip.models.clip.tokenizer import (
        CLIPTokenizer,
        bytes_to_unicode,
    )

    symbols = list(bytes_to_unicode().values())
    vocab = {}
    for s in symbols:
        vocab[s] = len(vocab)
    for s in symbols:
        vocab[s + "</w>"] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    vp, mp = str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt")
    json.dump(vocab, open(vp, "w"))
    open(mp, "w").write("#version: 0.2\n")

    ours = CLIPTokenizer(vp, mp)
    hf = HFTok(vocab_file=vp, merges_file=mp)
    for text in ("café table_ it's 42", "Naïve Über-model no.7"):
        assert ours.encode(text) == hf(text)["input_ids"][1:-1], text


def test_random_image_provider_builds_real_tower():
    """get_image_provider("random") must run the REAL vision tower (full
    ViT cost/code path, random weights) — not the hash stub — so the
    convergence run and weightless timing environments are tower-true."""
    from rangeclip.models.clip.provider import (
        CLIPImageEmbedder,
        get_image_provider,
    )

    cfg = CLIPConfig(**TINY_KW)
    provider = get_image_provider("random", config=cfg)
    assert isinstance(provider, CLIPImageEmbedder)
    crops = jnp.linspace(-1, 1, 2 * 32 * 32 * 3, dtype=jnp.float32).reshape(
        2, 32, 32, 3
    )
    out = np.asarray(provider(crops))
    assert out.shape == (2, TINY_KW["projection_dim"])
    # deterministic across construction (fixed init key)
    out2 = np.asarray(get_image_provider("random", config=cfg)(crops))
    np.testing.assert_array_equal(out, out2)
