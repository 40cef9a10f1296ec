"""End-to-end smoke: synthetic on-disk dataset -> trainer (2 steps) ->
checkpoint -> restore -> validation metrics.  Exercises the full stack the
way the CLI does."""

import os

import numpy as np
import pytest
import jax

from rangeclip.data.synthetic import write_synthetic_dataset


@pytest.mark.slow
def test_trainer_end_to_end(tmp_path):
    from rangeclip.training.trainer import TrainerConfig, train_depth_clip_model

    data = write_synthetic_dataset(str(tmp_path / "data"), n_samples=12,
                                   shape=(32, 32), num_classes=8)

    cfg = TrainerConfig(
        labeled_metadata_path=data["metadata"],
        labels_path=data["labels"],
        equivalence_dict_path=data["similarity"],
        batch_size=2,
        n_height=32,
        n_width=32,
        unet_architecture="resnet",
        learning_rates=[1e-3],
        learning_schedule=[2],
        scheduler_type="multi_step",
        w_weight_decay=1e-4,
        checkpoint_path=str(tmp_path / "ckpt"),
        n_step_per_checkpoint=1,
        n_step_per_summary=1,
        validation_start_step=1,
        accumulation_steps=2,
        embedding_dim=32,
        max_steps=2,
    )
    # shrink the model for CPU: patch the config the trainer builds
    import rangeclip.training.trainer as trainer_mod
    from rangeclip.models.depth_unet import DepthUNetConfig

    orig = DepthUNetConfig

    def small_cfg(**kw):
        kw["encoder_filters"] = (8, 16, 16, 16, 32)
        return orig(**kw)

    trainer_mod.DepthUNetConfig = small_cfg
    try:
        best = train_depth_clip_model(cfg)
    finally:
        trainer_mod.DepthUNetConfig = orig

    # validation ran and produced metrics
    assert best["step"] >= 1
    assert 0.0 <= best["mIoU_tk"] <= 1.0
    assert np.isfinite(best["loss"])

    # checkpoint written and restorable
    ckpt_dir = str(tmp_path / "ckpt" / "checkpoints")
    assert os.path.isdir(ckpt_dir)
    from rangeclip.training.checkpoint import CheckpointManager
    from rangeclip.training.optim import make_optimizer
    from rangeclip.training.state import create_train_state

    mgr = CheckpointManager(ckpt_dir)
    assert mgr.latest_step() == 2
    template = create_train_state(
        jax.random.key(0), small_cfg(embedding_dim=32, use_batch_norm=True),
        make_optimizer(1e-4), (2, 32, 32, 1),
    )
    restored = mgr.restore(template)
    assert int(restored.step) == 2

    # results log exists
    assert os.path.exists(str(tmp_path / "ckpt" / "results.txt"))


@pytest.mark.slow
def test_trainer_ddp_parity_smoke(tmp_path):
    """--ddp_parity wiring through the trainer: the shard_map train step
    builds against the trainer's own mesh and runs a real optimizer step
    (semantics proven in test_parallel; this covers the integration)."""
    from rangeclip.training.trainer import TrainerConfig, train_depth_clip_model

    data = write_synthetic_dataset(str(tmp_path / "data"), n_samples=8,
                                   shape=(32, 32), num_classes=8)
    cfg = TrainerConfig(
        labeled_metadata_path=data["metadata"],
        labels_path=data["labels"],
        equivalence_dict_path=data["similarity"],
        batch_size=2,
        n_height=32,
        n_width=32,
        learning_rates=[1e-3],
        learning_schedule=[1],
        checkpoint_path=str(tmp_path / "ckpt"),
        n_step_per_checkpoint=100,
        n_step_per_summary=100,
        validation_start_step=100,  # skip validation; train-step smoke only
        accumulation_steps=2,
        embedding_dim=32,
        max_steps=1,
        ddp_parity=True,
        encoder_filters=(8, 16, 16, 16, 32),
    )
    train_depth_clip_model(cfg)
    assert os.path.exists(str(tmp_path / "ckpt" / "results.txt"))


@pytest.mark.slow
def test_kill_and_resume_equivalence(tmp_path):
    """train-N == train-k -> kill -> --auto_resume -> N, BITWISE at fp32
    (VERDICT r4 #4): final params, optimizer state, BN stats, and step
    must match the straight-through run exactly.

    Holds because every source of training randomness is positional —
    per-step keys are fold_in(root, step), the loader order is keyed on
    (seed, epoch), curriculum/LR are epoch-derived — and because a
    mid-epoch resume skips exactly the accumulation windows its first
    epoch already consumed (the kill at k=2 lands mid-epoch-1 with 3
    optimizer steps per epoch, so this exercises the skip path, not just
    the epoch fast-forward).  Reference counterpart: manual restore at
    train_util.py:392-400, which both discards optimizer state and
    replays the epoch from its start — a deliberate divergence-fix
    (PARITY.md resume row).
    """
    from rangeclip.training.trainer import TrainerConfig, train_depth_clip_model
    from rangeclip.training.checkpoint import CheckpointManager
    from rangeclip.training.optim import make_optimizer
    from rangeclip.training.state import create_train_state
    from rangeclip.models.depth_unet import DepthUNetConfig

    data = write_synthetic_dataset(str(tmp_path / "data"), n_samples=12,
                                   shape=(32, 32), num_classes=8)

    def cfg_for(ckpt, max_steps, auto_resume=False):
        return TrainerConfig(
            labeled_metadata_path=data["metadata"],
            labels_path=data["labels"],
            equivalence_dict_path=data["similarity"],
            batch_size=2,
            n_height=32,
            n_width=32,
            learning_rates=[1e-3, 1e-4],
            learning_schedule=[1, 2],  # LR boundary inside the run
            scheduler_type="multi_step",
            w_weight_decay=1e-4,
            checkpoint_path=str(tmp_path / ckpt),
            n_step_per_checkpoint=100,  # only the final save writes
            n_step_per_summary=100,
            validation_start_step=100,  # no validation passes
            accumulation_steps=1,  # 3 optimizer steps per epoch
            embedding_dim=32,
            encoder_filters=(8, 16, 16, 16, 32),
            max_steps=max_steps,
            auto_resume=auto_resume,
        )

    N, K = 5, 2
    train_depth_clip_model(cfg_for("straight", N))
    train_depth_clip_model(cfg_for("resumed", K))
    train_depth_clip_model(cfg_for("resumed", N, auto_resume=True))

    template = create_train_state(
        jax.random.key(0),
        DepthUNetConfig(embedding_dim=32, use_batch_norm=True,
                        encoder_filters=(8, 16, 16, 16, 32)),
        make_optimizer(1e-4), (2, 32, 32, 1),
    )
    a = CheckpointManager(str(tmp_path / "straight" / "checkpoints")).restore(template)
    b = CheckpointManager(str(tmp_path / "resumed" / "checkpoints")).restore(template)
    assert int(a.step) == N and int(b.step) == N

    for name, ta, tb in (
        ("params", a.params, b.params),
        ("opt_state", a.opt_state, b.opt_state),
        ("batch_stats", a.batch_stats, b.batch_stats),
    ):
        la = jax.tree.leaves(ta)
        lb = jax.tree.leaves(tb)
        assert len(la) == len(lb)
        for xa, xb in zip(la, lb):
            np.testing.assert_array_equal(
                np.asarray(xa), np.asarray(xb),
                err_msg=f"{name} diverged between straight-through and "
                        f"kill-at-{K}/auto_resume runs")
