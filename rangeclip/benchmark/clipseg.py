"""CLIPSeg subject for the robustness benchmark.

Reference: benchmark/segclip.py:342-455 — the published robustness rows
(BASELINE.md) come from HF ``CIDAS/clipseg-rd64-refined``: per sample the
prompt set is the image's non-zero GT labels plus up to 20 distractors
(:370-375), CLIPSeg scores every prompt against the (perturbed) RGB image,
and per-pixel top-k over the prompt axis maps back to global label indices
(:416-417 + calculate_topk_metrics).

Split into two layers so the mapping logic is testable without weights:
  * :func:`clipseg_topk_from_logits` — pure JAX prompt-logits -> global
    top-k labels (resize to GT shape, top-k over prompts, index map);
  * :func:`make_clipseg_predict_fn` — wraps any
    ``logits_fn(prompts, image_hwc) -> [P, h, w]`` into the
    ``predict_fn(rng, batch, enhanced_image)`` contract of
    :func:`rangeclip.benchmark.robustness.robustness_sweep`;
  * :func:`hf_clipseg_logits_fn` — the HF torch adapter (local weights
    only; this framework makes no network calls), mirroring
    ``hf_segformer_logits_fn`` (evals/baselines.py).
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from rangeclip.ops.resize import resize_bilinear


def clipseg_topk_from_logits(
    logits: np.ndarray,
    global_indices: Sequence[int],
    target_shape,
    top_k: int = 5,
) -> jax.Array:
    """[P, h, w] per-prompt logits -> [H, W, top_k] global label indices.

    Matches the reference's calculate_topk_metrics preprocessing
    (segclip.py: bilinear resize to the GT map's shape, then top-k over the
    prompt axis and prompt->global index mapping).  When there are fewer
    prompts than ``top_k`` the trailing columns repeat the last prompt.
    """
    l = jnp.moveaxis(jnp.asarray(logits, jnp.float32), 0, -1)  # [h, w, P]
    l = resize_bilinear(l[None], tuple(target_shape))[0]  # [H, W, P]
    P = l.shape[-1]
    k = min(top_k, P)
    idx = jax.lax.top_k(l, k)[1]  # [H, W, k]
    gmap = jnp.asarray(list(global_indices), jnp.int32)
    topk = gmap[idx]
    if k < top_k:
        topk = jnp.concatenate(
            [topk] + [topk[..., -1:]] * (top_k - k), axis=-1
        )
    return topk


def make_clipseg_predict_fn(
    logits_fn: Callable[[List[str], np.ndarray], np.ndarray],
    labels: Sequence[str],
    num_distractors: int = 20,
    top_k: int = 5,
) -> Callable:
    """Build the sweep's ``predict_fn(rng, batch, enhanced_image)``.

    Per item (segclip.py:364-375): prompts = sorted non-zero GT labels +
    ``num_distractors`` distractors sampled without replacement from the
    remaining non-zero classes; ``logits_fn`` scores the prompts against
    the perturbed RGB; top-k over prompts maps back to global indices.
    Items with no non-zero GT labels predict label 0; the sweep harness
    weights such items out of the metrics entirely (robustness_sweep),
    matching the reference's per-sample skip — scoring a constant-0 row
    would count every background pixel as correct.
    """
    num_classes = len(labels)

    def predict_fn(rng: jax.Array, batch, enhanced_image: np.ndarray):
        seg_np = np.asarray(batch["segmentation"])
        B, H, W = seg_np.shape
        out = np.zeros((B, H, W, top_k), np.int32)
        seed = int(jax.random.randint(rng, (), 0, np.iinfo(np.int32).max))
        rstate = np.random.default_rng(seed)
        for b in range(B):
            gt = sorted(int(i) for i in np.unique(seg_np[b]) if i != 0)
            if not gt:
                continue
            pool = [i for i in range(1, num_classes) if i not in set(gt)]
            n_d = min(num_distractors, len(pool))
            distractors = (
                rstate.choice(pool, n_d, replace=False).tolist() if n_d else []
            )
            global_idx = gt + distractors
            prompts = [labels[i] for i in global_idx]
            logits = np.asarray(
                logits_fn(prompts, enhanced_image[b]), np.float32
            )
            out[b] = np.asarray(
                clipseg_topk_from_logits(logits, global_idx, (H, W), top_k)
            )
        return jnp.asarray(out)

    return predict_fn


def hf_clipseg_logits_fn(model_name_or_path: str, device: str = "cpu"):
    """HF torch CLIPSeg -> ``logits_fn`` (local weights only).

    Reproduces the reference inference call exactly (segclip.py:412-414):
    the image is repeated once per prompt, text is padded to max length,
    and the model returns [P, h, w] per-prompt segmentation logits.
    """
    import torch
    from transformers import CLIPSegForImageSegmentation, CLIPSegProcessor

    processor = CLIPSegProcessor.from_pretrained(model_name_or_path)
    model = CLIPSegForImageSegmentation.from_pretrained(model_name_or_path)
    model.eval().to(device)

    def logits_fn(prompts: List[str], image_hwc: np.ndarray) -> np.ndarray:
        img = np.clip(np.asarray(image_hwc, np.float32), 0.0, 1.0)
        img = (img * 255.0).astype(np.uint8)
        with torch.no_grad():
            inputs = processor(
                text=list(prompts),
                images=[img] * len(prompts),
                return_tensors="pt",
                padding="max_length",
            ).to(device)
            logits = model(**inputs).logits
        if logits.ndim == 2:  # single prompt: HF squeezes the prompt axis
            logits = logits[None]
        return logits.cpu().numpy()

    return logits_fn
