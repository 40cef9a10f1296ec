"""Validation harness.

Reference: validate.py:34-266 — per val batch: reduced-candidate predict
(50 negatives, top-5), equivalence-aware accuracy/mIoU accumulation,
qualitative grids, and a full val-loss recomputation including the
area-image pathway; aggregates, logs, and tracks best results keyed on
top-k mIoU (validate.py:234-244).

Design: one jitted ``val_step`` fuses predict + metric update +
loss for a whole batch; accumulators live on device and cross the host once
at the end.  Candidate-negative sampling and curriculum distractor draws
use explicit keys folded per batch.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from rangeclip.evals.metrics import metrics_finalize, metrics_init, metrics_update
from rangeclip.losses.hybrid import HybridLossConfig, compute_hybrid_loss
from rangeclip.losses.pooling import per_item_masked_pooling
from rangeclip.models.clip.crops import prepare_image_crops
from rangeclip.models.depth_unet import DepthUNet, build_candidate_mask
from rangeclip.utils.logging import log


def make_val_step(
    model: DepthUNet,
    loss_config: HybridLossConfig = HybridLossConfig(),
    top_k: int = 5,
    num_negatives: int = 50,
) -> Callable:
    """Build the fused per-batch validation step (jitted once)."""

    def val_step(
        params,
        batch_stats,
        batch: Dict[str, jax.Array],
        rng: jax.Array,
        pct_medium: jax.Array,
        pct_hard: jax.Array,
        text_table: jax.Array,
        medium_matrix: jax.Array,
        hard_matrix: jax.Array,
        equivalence_tensor: jax.Array,
        equiv_class_map: jax.Array,
        image_embeddings: jax.Array,
        acc: Dict[str, jax.Array],
    ):
        variables = {"params": params, "batch_stats": batch_stats}
        num_classes = text_table.shape[0]
        key_cand, key_loss = jax.random.split(rng)

        cand_mask = build_candidate_mask(
            key_cand, batch["segmentation"], num_classes, num_negatives
        )
        # The loss recompute consumes the NATIVE-resolution normalized field
        # via the exact upsample identities (hybrid.py label_upsample) —
        # same values, no full-res [B, H, W, D] materialization.
        pred_topk, pixel_emb, _ = model.apply(
            variables, batch["depth"], text_table, cand_mask, top_k,
            method=DepthUNet.predict, return_embeddings="native",
        )
        ups = batch["depth"].shape[1] // pixel_emb.shape[1]
        acc = metrics_update(
            acc, pred_topk, batch["segmentation"], equivalence_tensor,
            equiv_class_map, pixel_weight=batch["sample_valid"],
        )

        temps = {
            "t": jnp.exp(params["log_temperature_text"]),
            "i": jnp.exp(params["log_temperature_image"]),
        }
        area_emb = per_item_masked_pooling(
            pixel_emb, batch["segmentation"], batch["object_label"],
            upsample=ups,
        )
        total, info = compute_hybrid_loss(
            key_loss,
            pixel_emb,
            batch["segmentation"],
            text_table,
            medium_matrix,
            hard_matrix,
            temperature_text=temps["t"],
            temperature_image=temps["i"],
            pct_medium=pct_medium,
            pct_hard=pct_hard,
            area_embeddings=area_emb,
            image_embeddings=image_embeddings,
            area_valid=batch["sample_valid"],
            sample_weight=batch["sample_valid"],
            config=loss_config,
            label_upsample=ups,
        )
        loss_parts = jnp.stack(
            [
                info["total_loss"],
                info["text_contrastive_loss"],
                info["image_contrastive_loss"],
                info["smoothness_loss"],
            ]
        )
        return acc, loss_parts, pred_topk

    return jax.jit(val_step)


def _host_local_rows(arr) -> np.ndarray:
    """This process's contiguous batch rows of a (possibly sharded) array —
    for host-side rendering, where each host only needs the rows that came
    from its own loader.  Fully-replicated (or plain) arrays fetch whole.

    Assembled shard-by-shard from ``addressable_shards``, so it supports
    sharding over non-batch dims too (e.g. the 'spatial' H axis of
    parallel/mesh.py's 2x2x2 layout); replicated mesh axes repeat the same
    global index and overwrite with identical data."""
    if getattr(arr, "is_fully_replicated", True):
        return np.asarray(arr)
    blocks: Dict[int, np.ndarray] = {}
    for s in arr.addressable_shards:
        start = s.index[0].start or 0
        buf = blocks.get(start)
        if buf is None:
            n_rows = s.data.shape[0]
            buf = np.empty((n_rows,) + arr.shape[1:], dtype=arr.dtype)
            blocks[start] = buf
        buf[(slice(None),) + tuple(s.index[1:])] = np.asarray(s.data)
    return np.concatenate([blocks[k] for k in sorted(blocks)], axis=0)


def validate_model(
    model: DepthUNet,
    params,
    batch_stats,
    dataloader,
    text_table: jax.Array,
    medium_matrix: jax.Array,
    hard_matrix: jax.Array,
    equivalence_tensor: jax.Array,
    equiv_class_map: jax.Array,
    curriculum: Dict[str, float],
    image_provider,
    step: int,
    best_results: Dict,
    rng: jax.Array,
    loss_config: HybridLossConfig = HybridLossConfig(),
    top_k: int = 5,
    num_negatives: int = 50,
    log_path: Optional[str] = None,
    summary_writer=None,
    val_step_fn: Optional[Callable] = None,
    candidate_labels: Optional[Sequence[str]] = None,
    n_sample_per_summary: int = 0,
    mesh=None,
) -> Dict:
    """Run the full validation loop; returns updated ``best_results``.

    With ``candidate_labels`` and ``n_sample_per_summary`` set, the first
    batch's samples are rendered as [depth | image | GT | prediction]
    grids through the summary writer (reference validate.py:140-146).

    With ``mesh`` (the trainer's), every batch is placed 'data'-sharded on
    it — in a multi-process run each process contributes its val-loader
    shard to the GLOBAL batch (parallel/mesh.py shard_batch), the jitted
    step reduces metrics over all of it, and the logged numbers cover the
    whole validation set (the reference validates rank 0's sampler shard
    only, validate.py:34).  Host-side crop/CLIP preparation stays local.
    """
    num_classes = text_table.shape[0]
    if val_step_fn is None:
        val_step_fn = make_val_step(model, loss_config, top_k, num_negatives)

    acc = metrics_init(num_classes)
    loss_sums = jnp.zeros((4,), jnp.float32)
    n_batches = 0

    for i, batch in enumerate(dataloader):
        # Stay host-side until shard_batch/jit does the single upload:
        # pre-uploading with jnp.asarray would make the multi-process
        # branch of shard_batch (which assembles the global array from
        # process-LOCAL numpy) fetch every field back to the host.
        jbatch = {
            "depth": batch["depth"],
            "segmentation": batch["segmentation"],
            "object_label": batch["object_label"],
            "sample_valid": batch["sample_valid"],
        }
        crops = prepare_image_crops(
            jnp.asarray(batch["image"]), jnp.asarray(batch["object_bbox"])
        )
        image_embeddings = image_provider(crops)
        if mesh is not None:
            from rangeclip.parallel.mesh import shard_batch

            placed = shard_batch(
                mesh, dict(jbatch, image_embeddings=image_embeddings)
            )
            image_embeddings = placed.pop("image_embeddings")
            jbatch = placed
        else:
            image_embeddings = jnp.asarray(image_embeddings)

        acc, loss_parts, pred_topk = val_step_fn(
            params, batch_stats, jbatch, jax.random.fold_in(rng, i),
            jnp.float32(curriculum["pct_medium"]), jnp.float32(curriculum["pct_hard"]),
            text_table, medium_matrix, hard_matrix,
            equivalence_tensor, equiv_class_map, image_embeddings, acc,
        )
        loss_sums = loss_sums + loss_parts
        n_batches += 1

        if (
            i == 0
            and summary_writer is not None
            and candidate_labels is not None
            and n_sample_per_summary > 0
        ):
            from rangeclip.utils.visualization import prediction_grid

            pred_t1 = _host_local_rows(pred_topk)[..., 0]
            depth_np = np.asarray(batch["depth"])
            image_np = np.asarray(batch.get("image")) if "image" in batch else None
            seg_np = np.asarray(batch["segmentation"])
            for s in range(min(n_sample_per_summary, seg_np.shape[0])):
                grid = prediction_grid(
                    depth_np[s],
                    image_np[s] if image_np is not None else None,
                    seg_np[s],
                    pred_t1[s],
                    candidate_labels,
                )
                summary_writer.add_image(f"val/sample{s}", grid, step)

    results = metrics_finalize(acc)
    avg = np.asarray(loss_sums) / max(n_batches, 1)
    results.update(
        avg_loss=float(avg[0]),
        avg_text_contrastive_loss=float(avg[1]),
        avg_image_contrastive_loss=float(avg[2]),
        avg_smoothness_loss=float(avg[3]),
    )

    # Console output is a host-0-only duty like the reference's rank-0
    # gate (validate.py:34) — every process computes the global metrics
    # in lockstep, but only one narrates them.
    console = jax.process_index() == 0
    log(f"[Val] [Step {step}] Top-1 pixel accuracy (equiv): "
        f"{results['pixel_accuracy_t1']:.4f}", log_path, to_console=console)
    log(f"[Val] [Step {step}] Top-k pixel accuracy (equiv): "
        f"{results['pixel_accuracy_tk']:.4f}", log_path, to_console=console)
    log(f"[Val] [Step {step}] Top-1 mIoU (equiv): {results['mIoU_t1']:.4f}",
        log_path, to_console=console)
    log(f"[Val] [Step {step}] Top-k mIoU (equiv): {results['mIoU_tk']:.4f}",
        log_path, to_console=console)
    log(
        f"[Val] Step {step} | Loss: {results['avg_loss']:.4f}, "
        f"Text Contrastive: {results['avg_text_contrastive_loss']:.4f}, "
        f"Image Contrastive: {results['avg_image_contrastive_loss']:.4f}, "
        f"Smoothness: {results['avg_smoothness_loss']:.4f}",
        log_path,
        to_console=console,
    )

    # Latest (not best) validation loss — the plateau LR schedule keys on
    # this (optim.py step_metric contract: validation loss per epoch).
    best_results["latest_val_loss"] = results["avg_loss"]

    # Best-result tracking keyed on top-k mIoU (validate.py:234-244)
    if best_results.get("mIoU_tk", 0.0) < results["mIoU_tk"]:
        best_results.update(
            step=step,
            loss=results["avg_loss"],
            mIoU_t1=results["mIoU_t1"],
            mIoU_tk=results["mIoU_tk"],
            pixel_accuracy_t1=results["pixel_accuracy_t1"],
            pixel_accuracy_tk=results["pixel_accuracy_tk"],
            avg_text_contrastive_loss=results["avg_text_contrastive_loss"],
            avg_image_contrastive_loss=results["avg_image_contrastive_loss"],
            avg_smoothness_loss=results["avg_smoothness_loss"],
        )
    if "loss" in best_results and best_results.get("step", -1) >= 0:
        log(
            f"Best validation loss: {best_results['loss']:.4f} at step "
            f"{best_results['step']}",
            log_path,
            to_console=console,
        )

    if summary_writer is not None:
        summary_writer.add_scalars("val", results, step)

    return best_results
