"""HF CLIP checkpoint -> native parameter-tree conversion.

Lets users bring the exact ``openai/clip-vit-base-patch32`` weights the
reference uses (train_util.py:125-131) into the native towers.  Accepts a
state dict of numpy arrays (from ``torch.load`` or safetensors) and emits
the param trees for :class:`CLIPTextTower` / :class:`CLIPVisionTower`.

Layout notes: torch Linear weights are [out, in] -> transposed to [in, out];
the patch conv [out, in, kh, kw] -> HWIO.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np

from rangeclip.models.clip.model import CLIPConfig, CLIP_VIT_B32


def _dense(sd: Mapping[str, np.ndarray], prefix: str, bias: bool = True) -> Dict:
    out = {"kernel": np.ascontiguousarray(sd[f"{prefix}.weight"].T)}
    if bias:
        out["bias"] = sd[f"{prefix}.bias"]
    return out


def _ln(sd: Mapping[str, np.ndarray], prefix: str) -> Dict:
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _layer(sd: Mapping[str, np.ndarray], prefix: str) -> Dict:
    return {
        "layer_norm1": _ln(sd, f"{prefix}.layer_norm1"),
        "layer_norm2": _ln(sd, f"{prefix}.layer_norm2"),
        "attn": {
            "q_proj": _dense(sd, f"{prefix}.self_attn.q_proj"),
            "k_proj": _dense(sd, f"{prefix}.self_attn.k_proj"),
            "v_proj": _dense(sd, f"{prefix}.self_attn.v_proj"),
            "out_proj": _dense(sd, f"{prefix}.self_attn.out_proj"),
        },
        "fc1": _dense(sd, f"{prefix}.mlp.fc1"),
        "fc2": _dense(sd, f"{prefix}.mlp.fc2"),
    }


def convert_text_tower(
    state_dict: Mapping[str, np.ndarray], config: CLIPConfig = CLIP_VIT_B32
) -> Dict:
    sd = state_dict
    params = {
        "token_embedding": {
            "embedding": sd["text_model.embeddings.token_embedding.weight"]
        },
        "position_embedding": sd["text_model.embeddings.position_embedding.weight"],
        "final_layer_norm": _ln(sd, "text_model.final_layer_norm"),
        "text_projection": _dense(sd, "text_projection", bias=False),
    }
    for i in range(config.text_layers):
        params[f"layer{i}"] = _layer(sd, f"text_model.encoder.layers.{i}")
    return params


def convert_vision_tower(
    state_dict: Mapping[str, np.ndarray], config: CLIPConfig = CLIP_VIT_B32
) -> Dict:
    sd = state_dict
    patch = sd["vision_model.embeddings.patch_embedding.weight"]
    params = {
        "patch_embedding": {
            "kernel": np.ascontiguousarray(np.transpose(patch, (2, 3, 1, 0)))
        },
        "class_embedding": sd["vision_model.embeddings.class_embedding"],
        "position_embedding": sd["vision_model.embeddings.position_embedding.weight"],
        # HF spells it "pre_layrnorm"
        "pre_layernorm": _ln(sd, "vision_model.pre_layrnorm"),
        "post_layernorm": _ln(sd, "vision_model.post_layernorm"),
        "visual_projection": _dense(sd, "visual_projection", bias=False),
    }
    for i in range(config.vision_layers):
        params[f"layer{i}"] = _layer(sd, f"vision_model.encoder.layers.{i}")
    return params


def load_hf_clip_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Load an HF CLIP checkpoint file (.bin via torch, .safetensors via the
    safetensors library) into a numpy state dict."""
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file

        return dict(load_file(path))
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.numpy() for k, v in sd.items()}


def convert_clip_checkpoint(
    path: str, config: CLIPConfig = CLIP_VIT_B32
) -> Tuple[Dict, Dict]:
    """-> (text_params, vision_params)."""
    sd = load_hf_clip_checkpoint(path)
    return convert_text_tower(sd, config), convert_vision_tower(sd, config)
