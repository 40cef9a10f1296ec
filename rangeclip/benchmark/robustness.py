"""Brightness/saturation robustness sweep.

Reference: benchmark/segclip.py — sweeps PIL ImageEnhance brightness and
saturation (color) levels over sampled images, prompts each sample's GT
labels plus 20 distractors, and reports equivalence-aware top-1/top-k
accuracy and mIoU per perturbation level (:23-28, 51-58, 60-140, 353-455).

This harness is generic over the segmenter: plug in any
``predict_fn(rng, batch, enhanced_image) -> [B, H, W, k] label indices`` —
the depth model (perturbations only affect the RGB used for prompts/crops),
the MaskCLIP dense probe (evals/baselines.py), or an external CLIPSeg-style
model.  Enhancement math replicates PIL.ImageEnhance semantics:
  brightness(f): img * f
  color(f):      grayscale + f * (img - grayscale), L = 0.299R+0.587G+0.114B
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from rangeclip.evals.metrics import metrics_finalize, metrics_init, metrics_update


def enhance_brightness(image: np.ndarray, factor: float) -> np.ndarray:
    """image [H, W, 3] float in [0, 1]."""
    return np.clip(image * factor, 0.0, 1.0)


def enhance_saturation(image: np.ndarray, factor: float) -> np.ndarray:
    lum = (
        0.299 * image[..., 0] + 0.587 * image[..., 1] + 0.114 * image[..., 2]
    )[..., None]
    return np.clip(lum + factor * (image - lum), 0.0, 1.0)


def robustness_sweep(
    dataloader_factory: Callable[[], object],
    predict_fn: Callable,
    equivalence_tensor,
    equiv_class_map,
    num_classes: int,
    brightness_levels: Sequence[float] = (1.0, 0.5, 0.2, 0.1, 0.05, 0.02, 0.01),
    saturation_levels: Sequence[float] = (1.0,),
    seed: int = 0,
) -> List[Dict]:
    """Run the sweep; returns one result row per (brightness, saturation)."""
    et = jnp.asarray(equivalence_tensor)
    ecm = jnp.asarray(equiv_class_map)
    update = jax.jit(metrics_update)
    results = []
    rng = jax.random.key(seed)

    for b in brightness_levels:
        for s in saturation_levels:
            acc = metrics_init(num_classes)
            for i, batch in enumerate(dataloader_factory()):
                image = np.stack(
                    [
                        enhance_saturation(enhance_brightness(img, b), s)
                        for img in batch["image"]
                    ]
                )
                pred = predict_fn(jax.random.fold_in(rng, i), batch, image)
                # The reference SKIPS items with no non-zero GT labels
                # (segclip.py per-sample guard) — scoring them would count
                # every gt==0 pixel as a correct background prediction and
                # inflate accuracy, so weight them out alongside padding.
                seg_np = np.asarray(batch["segmentation"])
                has_gt = (seg_np != 0).any(axis=(1, 2)).astype(np.float32)
                acc = update(
                    acc, pred, jnp.asarray(batch["segmentation"]), et, ecm,
                    pixel_weight=jnp.asarray(
                        np.asarray(batch["sample_valid"], np.float32) * has_gt
                    ),
                )
            row = metrics_finalize(acc)
            row.update(brightness=b, saturation=s)
            results.append(row)
    return results


def plot_results(results: List[Dict], output_png: str) -> str:
    """Metric-vs-brightness curves per saturation level (the reference's
    matplotlib aggregation, segclip.py:463-516) -> PNG path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    metrics = [
        ("pixel_accuracy_t1", "Top-1 pixel accuracy"),
        ("pixel_accuracy_tk", "Top-k pixel accuracy"),
        ("mIoU_t1", "Top-1 mIoU"),
        ("mIoU_tk", "Top-k mIoU"),
    ]
    sats = sorted({r["saturation"] for r in results})
    fig, axes = plt.subplots(1, len(metrics), figsize=(4.5 * len(metrics), 4))
    for ax, (key, title) in zip(np.atleast_1d(axes), metrics):
        for s in sats:
            rows = sorted(
                (r for r in results if r["saturation"] == s),
                key=lambda r: r["brightness"],
            )
            ax.plot(
                [r["brightness"] for r in rows],
                [r[key] for r in rows],
                marker="o",
                label=f"saturation {s:g}",
            )
        ax.set_xscale("log")
        ax.set_xlabel("brightness factor")
        ax.set_title(title)
        ax.set_ylim(0, 1)
        ax.grid(True, alpha=0.3)
    if len(sats) > 1:
        axes[0].legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(output_png, dpi=120)
    plt.close(fig)
    return output_png


def format_results_table(results: List[Dict]) -> str:
    lines = [
        "brightness saturation  acc_t1  acc_tk  mIoU_t1  mIoU_tk",
    ]
    for r in results:
        lines.append(
            f"{r['brightness']:10.2f} {r['saturation']:10.2f} "
            f"{r['pixel_accuracy_t1']:7.4f} {r['pixel_accuracy_tk']:7.4f} "
            f"{r['mIoU_t1']:8.4f} {r['mIoU_tk']:8.4f}"
        )
    return "\n".join(lines)
