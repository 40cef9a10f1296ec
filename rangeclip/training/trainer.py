"""End-to-end training orchestration.

Reference: train_util.py:65-430 (``train_depth_clip_model``) — data setup,
label structures, frozen CLIP, model/optimizer construction, restore paths,
text-embedding precompute + broadcast, the epoch loop with curriculum,
gradient accumulation, per-step summaries, periodic validation and
checkpointing, and the final save.

Changes from the reference:
  * one jitted train step consumes a whole accumulation window (8
    microbatches) — see train_step.py;
  * the text table is precomputed once and placed replicated on the mesh
    (the reference's rank-0 NCCL broadcast, train_util.py:230-240);
  * frozen CLIP crop embeddings are computed by a separately-jitted tower
    (keeping the train step's compile independent) ONCE per accumulation
    window on the whole window's crops, and stay device-resident — the
    tower dispatch overlaps the step instead of serializing a host fetch
    per microbatch (the reference's per-batch throughput cliff,
    train_util.py:305-315); skipped entirely when the image loss weight
    is 0;
  * multi-process runs execute validation compute and checkpoint saves on
    EVERY process in lockstep (multihost jit requirement); only the IO
    side effects (logs, TB writers, summaries) are gated on
    ``jax.process_index() == 0`` like the reference's rank-0 duties;
  * resume fast-forwards the epoch loop to the restored step's epoch, so
    the LR schedule and curriculum continue instead of replaying (the
    reference restarts its epoch loop and schedule from scratch,
    train_util.py:272/409);
  * restore keeps optimizer state (the reference discards it — SURVEY.md
    section 5 checkpoint quirk, deliberately fixed).
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from rangeclip.data.labels import (
    build_equivalence_class_map,
    build_equivalence_tensor,
    build_similarity_matrices,
    load_equivalence_dict,
    load_label_similarity_sets,
)
from rangeclip.data.loader import setup_dataloaders
from rangeclip.evals.validate import make_val_step, validate_model
from rangeclip.losses.hybrid import HybridLossConfig
from rangeclip.models.clip.crops import prepare_image_crops
from rangeclip.models.depth_unet import DepthUNet, DepthUNetConfig
from rangeclip.parallel.mesh import make_mesh, replicate, shard_batch
from rangeclip.training.checkpoint import CheckpointManager
from rangeclip.training.curriculum import get_curriculum_schedule
from rangeclip.training.optim import make_lr_schedule, make_optimizer
from rangeclip.training.state import create_train_state
from rangeclip.training.train_step import make_train_step
from rangeclip.utils.logging import (
    ScalarWriter,
    log,
    log_configuration,
    log_training_summary,
)


@dataclasses.dataclass
class TrainerConfig:
    """Canonical flags (train.py:24-82 + launcher defaults)."""

    labeled_metadata_path: str = ""
    labels_path: str = ""
    equivalence_dict_path: str = ""
    # Per-PROCESS microbatch size, like the reference's per-GPU batch
    # (train_segmentation_model.sh: batch 2 per GPU x 2 GPUs).  The global
    # microbatch is batch_size * jax.process_count().
    batch_size: int = 2
    n_height: int = 224
    n_width: int = 224
    unet_architecture: str = "resnet"
    learning_rates: Sequence[float] = (2e-4, 1e-4, 5e-5, 1e-5)
    learning_schedule: Sequence[int] = (10, 20, 30, 35)
    scheduler_type: str = "multi_step"
    w_weight_decay: float = 1e-4
    checkpoint_path: str = "checkpoints"
    n_step_per_checkpoint: int = 1000
    n_step_per_summary: int = 500
    # Validation cadence; None = every n_step_per_summary (the reference's
    # single-knob behavior, train_util.py:371-390).  A separate knob lets
    # long runs log dense train scalars without paying a full validation
    # pass at every summary step.
    n_step_per_validation: Optional[int] = None
    n_sample_per_summary: int = 32
    validation_start_step: int = 5000
    restore_path_model: Optional[str] = None
    restore_path_encoder: Optional[str] = None
    # None -> freeze exactly when restore_path_encoder is given (the
    # reference's intent: train_util.py:158 restores the encoder with
    # freeze_encoder=True); True/False overrides.
    freeze_encoder: Optional[bool] = None
    clip_checkpoint_path: Optional[str] = None
    clip_vocab_path: Optional[str] = None
    clip_merges_path: Optional[str] = None
    accumulation_steps: int = 8
    w_text: float = 1.0
    w_image: float = 0.5
    w_smooth: float = 2e2
    # Class-balanced pixel-text CE weighting (opt-in divergence from the
    # reference's uniform sampling; see HybridLossConfig.class_balanced).
    class_balanced: bool = False
    embedding_dim: int = 512
    use_batch_norm: bool = True
    seed: int = 0
    bf16: bool = False
    # Reference-exact multi-device semantics (torch DDP): per-replica BN
    # statistics + per-rank local losses under shard_map, gradients
    # pmean'd.  Default False = global-batch sync-BN.
    ddp_parity: bool = False
    max_steps: Optional[int] = None  # early-exit knob for smoke runs
    auto_resume: bool = False  # pick up the latest checkpoint in
    # checkpoint_path automatically (preemption recovery; beyond the
    # reference's manual --restore_path_model)
    profile_dir: Optional[str] = None  # jax.profiler trace of steps 2..4
    # None -> the flagship ResNet-18 widths (encoder.py:42-53); smaller
    # tuples are for smoke drives / CPU tests (matches the convert/export
    # CLIs' --encoder_filters knob).
    encoder_filters: Optional[Sequence[int]] = None


def _accumulate_microbatches(microbatches):
    """Stack host microbatches into the [A, B, ...] layout the step expects
    (image embeddings are handled separately — they are DEVICE arrays from
    the window tower call, see ``_make_window_tower``)."""
    out = {
        "depth": np.stack([mb["depth"] for mb in microbatches]).astype(np.float32),
        "segmentation": np.stack([mb["segmentation"] for mb in microbatches]).astype(
            np.int32
        ),
        "object_label": np.stack([mb["object_label"] for mb in microbatches]).astype(
            np.int32
        ),
        "sample_valid": np.stack([mb["sample_valid"] for mb in microbatches]).astype(
            np.float32
        ),
    }
    return out


def _make_window_tower(image_provider):
    """One async device-resident tower call per ACCUMULATION WINDOW.

    The reference runs ``prepare_image_contrast_data`` once per microbatch
    with a blocking host round trip (train_util.py:305-315 →
    dataloader.py:205-306 — SURVEY's throughput cliff); round 2 still
    fetched each microbatch's crop embeddings to host
    (``np.asarray(image_provider(...))``) and re-uploaded them, stalling
    async dispatch 8x per optimizer step.  Here the whole window's crops
    go through ONE jitted crop-extraction call and one tower call, and the
    [A, B, D] embeddings never leave the device, so no HOST latency is
    added on top of the tower's device time.
    """
    crop_fn = jax.jit(prepare_image_crops, static_argnames=("out_size",
                                                            "normalize"))

    def window_tower(microbatches):
        images = np.stack([mb["image"] for mb in microbatches])
        bboxes = np.stack([mb["object_bbox"] for mb in microbatches])
        A, B = images.shape[:2]
        crops = crop_fn(
            jnp.asarray(images.reshape((A * B,) + images.shape[2:])),
            jnp.asarray(bboxes.reshape(A * B, 4)),
        )
        embs = image_provider(crops)
        return embs.reshape(A, B, embs.shape[-1]).astype(jnp.float32)

    return window_tower


def _place_image_embeddings(mesh, embs, nproc):
    """Shard the window's [A, B, D] embeddings over 'data' without a host
    round trip (single process: a device-to-device reshard).  Multi-process
    runs must assemble the global batch from per-process rows, which
    requires host data (make_array_from_process_local_data) — the one
    remaining fetch, per window not per microbatch, on the multi-host path
    only."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P(None, "data", None))
    if nproc == 1:
        return jax.device_put(embs, sharding)
    local = np.asarray(embs)
    gshape = (local.shape[0], local.shape[1] * nproc, local.shape[2])
    return jax.make_array_from_process_local_data(sharding, local, gshape)


def train_depth_clip_model(cfg: TrainerConfig) -> Dict:
    """Run the full training job; returns final best_results."""
    is_host0 = jax.process_index() == 0
    time_start = time.time()

    ckpt_root = os.path.abspath(cfg.checkpoint_path)
    log_path = os.path.join(ckpt_root, "results.txt") if is_host0 else None
    event_path = os.path.join(ckpt_root, "tensorboard")
    n_epoch = cfg.learning_schedule[-1]

    # --- data ---------------------------------------------------------
    (train_loader, val_loader, _test_loader, n_train_steps, candidate_labels
     ) = setup_dataloaders(
        cfg.labeled_metadata_path,
        cfg.labels_path,
        (cfg.n_height, cfg.n_width),
        cfg.batch_size,
        n_epoch,
        shard_id=jax.process_index(),
        num_shards=jax.process_count(),
    )
    num_classes = len(candidate_labels)

    # --- label structures (dataloader.py:147-202) ---------------------
    equivalence_dict = load_equivalence_dict(cfg.equivalence_dict_path)
    equivalence_tensor = build_equivalence_tensor(equivalence_dict, num_classes)
    similarity_sets = load_label_similarity_sets(cfg.equivalence_dict_path, num_classes)
    medium_np, hard_np = build_similarity_matrices(similarity_sets, num_classes)
    equiv_class_map = build_equivalence_class_map(equivalence_tensor)

    # --- frozen CLIP providers ----------------------------------------
    from rangeclip.models.clip.provider import get_image_provider, get_text_provider

    text_provider = get_text_provider(
        cfg.clip_checkpoint_path, cfg.clip_vocab_path, cfg.clip_merges_path,
        dim=cfg.embedding_dim,
    )
    image_provider = get_image_provider(cfg.clip_checkpoint_path, dim=cfg.embedding_dim)

    if is_host0:
        log(f"Precomputing text embeddings for {num_classes} candidate labels...",
            log_path)
    text_table_np = text_provider(candidate_labels)

    # --- model + optimizer --------------------------------------------
    freeze_encoder = (
        cfg.freeze_encoder
        if cfg.freeze_encoder is not None
        else cfg.restore_path_encoder is not None
    )
    model_kwargs = {}
    if cfg.encoder_filters is not None:
        model_kwargs["encoder_filters"] = tuple(cfg.encoder_filters)
    model_cfg = DepthUNetConfig(
        unet_type=cfg.unet_architecture,
        embedding_dim=cfg.embedding_dim,
        use_batch_norm=cfg.use_batch_norm,
        dtype=jnp.bfloat16 if cfg.bf16 else None,
        freeze_encoder=freeze_encoder,
        **model_kwargs,
    )
    model = DepthUNet(model_cfg)
    optimizer = make_optimizer(cfg.w_weight_decay, freeze_encoder=freeze_encoder)
    state = create_train_state(
        jax.random.key(cfg.seed), model_cfg, optimizer,
        (cfg.batch_size, cfg.n_height, cfg.n_width, 1),
    )

    ckpt = CheckpointManager(os.path.join(ckpt_root, "checkpoints"))
    if cfg.auto_resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        log(f"Auto-resumed from step {int(state.step)} "
            f"(preemption recovery).", log_path, to_console=is_host0)
    elif cfg.restore_path_encoder:
        enc_ckpt = CheckpointManager(cfg.restore_path_encoder)
        enc_params, enc_stats = enc_ckpt.restore_encoder_params(state)
        state = state.replace(params=enc_params, batch_stats=enc_stats)
        log(
            "Restored encoder weights"
            + (" (frozen-encoder finetune)." if freeze_encoder else "."),
            log_path,
            to_console=is_host0,
        )
    elif cfg.restore_path_model:
        restore_mgr = CheckpointManager(cfg.restore_path_model)
        state = restore_mgr.restore(state)
        log(f"Restored checkpoint at step {int(state.step)}.", log_path,
            to_console=is_host0)

    start_step = int(state.step)

    # --- mesh placement -----------------------------------------------
    # The data axis must divide the GLOBAL per-step batch
    # (batch_size per process x process_count, the reference's per-GPU
    # batch semantics) and give every process a whole number of rows; use
    # process_count times the largest divisor of the local batch that fits
    # the local device count (full device count in the production config,
    # fewer when debugging with tiny batches).
    n_data = jax.process_count() * math.gcd(
        cfg.batch_size, jax.local_device_count()
    )
    mesh = make_mesh(n_data=n_data)
    state = replicate(mesh, state)
    text_table = replicate(mesh, jnp.asarray(text_table_np, jnp.float32))
    medium_matrix = replicate(mesh, jnp.asarray(medium_np))
    hard_matrix = replicate(mesh, jnp.asarray(hard_np))
    equivalence_j = replicate(mesh, jnp.asarray(equivalence_tensor))
    equiv_map_j = replicate(mesh, jnp.asarray(equiv_class_map))

    loss_cfg = HybridLossConfig(
        w_text=cfg.w_text, w_image=cfg.w_image, w_smooth=cfg.w_smooth,
        class_balanced=cfg.class_balanced,
    )
    train_step = make_train_step(model, optimizer, loss_cfg,
                                 cfg.accumulation_steps,
                                 ddp_parity=cfg.ddp_parity, mesh=mesh)
    val_step = make_val_step(model, loss_cfg)
    schedule = make_lr_schedule(cfg.scheduler_type, cfg.learning_rates,
                                cfg.learning_schedule)

    if is_host0:
        n_params = sum(x.size for x in jax.tree.leaves(state.params))
        log_configuration(log_path, {
            "metadata": cfg.labeled_metadata_path,
            "batch_size": cfg.batch_size,
            "resolution": f"{cfg.n_height}x{cfg.n_width}",
            "architecture": cfg.unet_architecture,
            "n_parameters": n_params,
            "n_train_steps": n_train_steps,  # microbatches (reference unit)
            "n_optimizer_steps": (max(1, len(train_loader)
                                      // cfg.accumulation_steps) * n_epoch),
            "learning_rates": list(cfg.learning_rates),
            "learning_schedule": list(cfg.learning_schedule),
            "scheduler": cfg.scheduler_type,
            "weight_decay": cfg.w_weight_decay,
            "accumulation_steps": cfg.accumulation_steps,
            "loss_weights": (cfg.w_text, cfg.w_image, cfg.w_smooth),
            "devices": jax.device_count(),
            "mesh": dict(mesh.shape),
            "precision": "bf16" if cfg.bf16 else "fp32",
            "bn_semantics": ("per-replica (ddp_parity)" if cfg.ddp_parity
                             else "global-batch sync-BN"),
            "checkpoint_path": ckpt_root,
        })
        train_writer = ScalarWriter(event_path + "-train")
        val_writer = ScalarWriter(event_path + "-val")
    else:
        train_writer = val_writer = None

    best_results: Dict = {"step": -1, "loss": float("inf")}
    # POSITIONAL per-step keys (round 5): step s always trains under
    # fold_in(root, s), regardless of where the process started.  The
    # previous sequential-split chain (rng, step_rng = split(rng) from
    # process start) made a resumed run draw different pixel samples /
    # distractors than the straight-through run from the same step, so
    # train-N == train-k->resume->N held only in distribution.  With
    # positional keys it holds BITWISE at fp32
    # (tests/test_e2e.py::test_kill_and_resume_equivalence).
    rng_root = jax.random.key(cfg.seed + 1)
    train_step_count = start_step
    done = False
    nproc = jax.process_count()
    window_tower = _make_window_tower(image_provider)

    # Optimizer steps per epoch: the loader yields floor(n_shard/batch)
    # microbatches (drop_last) and the step consumes accumulation_steps of
    # them; leftovers at epoch end are dropped.  Used for (a) the Step X/Y
    # progress denominator (the reference mixes units here — its
    # n_train_steps counts microbatches, train_util.py:475-486, an ~8x ETA
    # overstatement we fix) and (b) fast-forwarding the epoch loop on
    # resume so the LR schedule and curriculum continue where the
    # restored step left off instead of replaying from epoch 1.
    opt_steps_per_epoch = max(1, len(train_loader) // cfg.accumulation_steps)
    n_opt_steps_total = opt_steps_per_epoch * n_epoch
    epoch_start = min(start_step // opt_steps_per_epoch, n_epoch - 1) + 1
    # Mid-epoch resume: the restored step may sit inside epoch_start, so
    # the first resumed epoch must SKIP the accumulation windows that
    # epoch already consumed before the checkpoint — otherwise resumed
    # step k+1 would see epoch_start's first batches again (and the run
    # would overshoot the schedule by the replayed windows).  The skipped
    # windows stream through the loader (keeping its epoch-keyed order)
    # but run no tower call and no optimizer step.
    skip_windows = start_step - (epoch_start - 1) * opt_steps_per_epoch
    if start_step and (epoch_start > 1 or skip_windows):
        log(f"Resuming at epoch {epoch_start}/{n_epoch} "
            f"(step {start_step}; skipping {skip_windows} consumed "
            f"window(s) of epoch {epoch_start}).", log_path,
            to_console=is_host0)

    log(f"{jax.process_index()} Begin training...", log_path)

    for epoch in range(epoch_start, n_epoch + 1):
        if done:
            break
        train_loader.set_epoch(epoch)
        curriculum = get_curriculum_schedule(epoch, n_epoch)
        lr = schedule(epoch - 1)
        # Device-side loss accumulator: fetching the loss every step blocks
        # async dispatch and stalls the input pipeline, so the running sum
        # stays on device and crosses to the host only on the summary /
        # checkpoint / epoch-end cadences.
        loss_sum = None
        loss_count = 0

        microbatches = []
        for batch in train_loader:
            microbatches.append(batch)
            if len(microbatches) < cfg.accumulation_steps:
                continue

            if epoch == epoch_start and skip_windows > 0:
                skip_windows -= 1
                microbatches = []
                continue

            step_batch = _accumulate_microbatches(microbatches)
            if cfg.w_image > 0:
                # ONE async tower call per accumulation window; the
                # [A, B, D] embeddings stay device-resident and are placed
                # after the host arrays shard (no per-microbatch host
                # sync — _make_window_tower)
                window_embs = window_tower(microbatches)
            else:
                # the step never reads image_embeddings when the image
                # loss is off (train_step.py use_image_loss gate) — skip
                # the frozen CLIP forward entirely
                window_embs = None
                step_batch["image_embeddings"] = np.zeros(
                    step_batch["object_label"].shape + (cfg.embedding_dim,),
                    np.float32,
                )
            microbatches = []
            step_batch = shard_batch(mesh, step_batch, batch_axis=1)
            if window_embs is not None:
                step_batch["image_embeddings"] = _place_image_embeddings(
                    mesh, window_embs, nproc
                )

            step_rng = jax.random.fold_in(rng_root, train_step_count)
            if cfg.profile_dir and train_step_count == start_step + 1:
                jax.profiler.start_trace(cfg.profile_dir)
            state, info = train_step(
                state, step_batch, step_rng, jnp.float32(lr),
                jnp.float32(curriculum["pct_medium"]),
                jnp.float32(curriculum["pct_hard"]),
                text_table, medium_matrix, hard_matrix,
            )
            train_step_count += 1
            if cfg.profile_dir and train_step_count == start_step + 4:
                jax.block_until_ready(state)
                jax.profiler.stop_trace()
                log(f"Profiler trace written to {cfg.profile_dir}", log_path,
                    to_console=is_host0)
            loss_sum = (info["total_loss"] if loss_sum is None
                        else loss_sum + info["total_loss"])
            loss_count += 1

            if is_host0 and train_step_count % cfg.n_step_per_summary == 0:
                train_writer.add_scalar("Loss/train_step",
                                        float(info["total_loss"]),
                                        train_step_count)
                train_writer.add_scalar("Loss/text_contrast",
                                        float(info["text_contrastive_loss"]),
                                        train_step_count)
                train_writer.add_scalar("Loss/image_contrast",
                                        float(info["image_contrastive_loss"]),
                                        train_step_count)
                train_writer.add_scalar("Loss/smoothness",
                                        float(info["smoothness_loss"]),
                                        train_step_count)
                train_writer.add_scalar("Params/temperature_text",
                                        float(info["temperature_text"]),
                                        train_step_count)
                train_writer.add_scalar("Params/temperature_image",
                                        float(info["temperature_image"]),
                                        train_step_count)
                train_writer.add_scalar("Params/learning_rate", lr, train_step_count)
                train_writer.add_scalars("train/curriculum", curriculum,
                                         train_step_count)

            n_step_per_validation = (cfg.n_step_per_validation
                                     or cfg.n_step_per_summary)
            if (
                train_step_count >= cfg.validation_start_step
                and train_step_count % n_step_per_validation == 0
            ):
                # EVERY process runs the jitted val compute in lockstep
                # (multi-host jit needs each process to feed its
                # addressable shards; host-0-only launch would deadlock) —
                # log_path/summary_writer are None off host 0, so the IO
                # side effects stay rank-0-only like the reference
                # (validate.py rank-0 gate, train_util.py:371-390).
                best_results = validate_model(
                    model, state.params, state.batch_stats, val_loader,
                    text_table, medium_matrix, hard_matrix,
                    equivalence_j, equiv_map_j, curriculum, image_provider,
                    train_step_count, best_results, jax.random.key(999),
                    loss_cfg, log_path=log_path, summary_writer=val_writer,
                    val_step_fn=val_step,
                    candidate_labels=candidate_labels,
                    n_sample_per_summary=cfg.n_sample_per_summary,
                    mesh=mesh,
                )

            if train_step_count % cfg.n_step_per_checkpoint == 0:
                if is_host0:
                    avg = float(loss_sum) / loss_count if loss_count else 0.0
                    log_training_summary(log_path, train_step_count,
                                         n_opt_steps_total, start_step, avg,
                                         time_start)
                # all processes participate in the (multihost) save
                ckpt.save(state)

            if cfg.max_steps is not None and train_step_count >= cfg.max_steps:
                done = True
                break

        avg_epoch = float(loss_sum) / loss_count if loss_count else 0.0
        if is_host0:
            log(
                f"Epoch {epoch} END | Step {train_step_count} | "
                f"Avg Loss: {avg_epoch:.7f} | LR: {lr}",
                log_path,
            )
            if train_writer:
                train_writer.add_scalar("Loss/train_epoch", avg_epoch, epoch)
        # Plateau scheduling keys on the latest VALIDATION loss when any
        # validation has run (the optim.py step_metric contract; torch's
        # ReduceLROnPlateau reference usage), falling back to the train
        # epoch loss before validation_start_step.
        schedule.step_metric(
            best_results.get("latest_val_loss", avg_epoch))

    ckpt.save(state)  # all processes (multihost)
    if is_host0:
        log("Training finished.", log_path)
        if train_writer:
            train_writer.close()
        if val_writer:
            val_writer.close()
    return best_results
