"""REAL multi-process data parallelism (the reference's torchrun DDP,
train.py:15-19) — not the single-process virtual mesh the rest of the
suite uses.

Launches the actual trainer in 2 OS processes (4 virtual CPU devices
each, gloo collectives), each loading its own dataset shard, and checks
the run against a single-process simulation that feeds the SAME global
batches through the same jitted train step on a same-shape mesh:

  * per-step training math (global-batch assembly via
    jax.make_array_from_process_local_data, sync-BN over the global
    batch, the gradient all-reduce) must agree with the simulation;
  * validation must aggregate GLOBAL metrics (both processes run the val
    compute in lockstep on 'data'-sharded global batches) and agree with
    the simulation's mesh validation;
  * both processes must finish, report identical results, and the
    (multihost) checkpoint must be restorable.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from rangeclip.data.synthetic import write_synthetic_dataset

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(TESTS_DIR)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _simulate_single_process(data, n_steps=2):
    """The trainer's exact 2-process computation in one process: two loader
    shards, global batch = [shard-0 rows; shard-1 rows], same mesh shape
    (n_data=4), same RNG stream, same curriculum/LR — per-step losses and
    the validation results must match the real 2-process run."""
    from rangeclip.data.loader import setup_dataloaders
    from rangeclip.data.labels import (
        build_equivalence_class_map,
        build_equivalence_tensor,
        build_similarity_matrices,
        load_equivalence_dict,
        load_label_similarity_sets,
    )
    from rangeclip.evals.validate import make_val_step, validate_model
    from rangeclip.losses.hybrid import HybridLossConfig
    from rangeclip.models.clip.crops import prepare_image_crops
    from rangeclip.models.clip.provider import (
        get_image_provider,
        get_text_provider,
    )
    from rangeclip.models.depth_unet import DepthUNet, DepthUNetConfig
    from rangeclip.parallel.mesh import make_mesh, replicate, shard_batch
    from rangeclip.training.curriculum import get_curriculum_schedule
    from rangeclip.training.optim import make_lr_schedule, make_optimizer
    from rangeclip.training.state import create_train_state
    from rangeclip.training.train_step import make_train_step

    loaders = []
    for shard in (0, 1):
        train_loader, val_loader, _, _, labels = setup_dataloaders(
            data["metadata"], data["labels"], (32, 32), 2, n_epoch=1,
            shard_id=shard, num_shards=2,
        )
        loaders.append((train_loader, val_loader))
    num_classes = len(labels)

    equivalence_tensor = build_equivalence_tensor(
        load_equivalence_dict(data["similarity"]), num_classes
    )
    medium_np, hard_np = build_similarity_matrices(
        load_label_similarity_sets(data["similarity"], num_classes), num_classes
    )
    equiv_map = build_equivalence_class_map(equivalence_tensor)

    text_provider = get_text_provider(None, None, None, dim=32)
    image_provider = get_image_provider(None, dim=32)
    text_table_np = text_provider(labels)

    model_cfg = DepthUNetConfig(
        unet_type="resnet", embedding_dim=32, use_batch_norm=True,
        encoder_filters=(8, 16, 16, 16, 32),
    )
    model = DepthUNet(model_cfg)
    optimizer = make_optimizer(1e-4)
    state = create_train_state(
        jax.random.key(0), model_cfg, optimizer, (2, 32, 32, 1)
    )

    # same mesh SHAPE as the 2-process run: n_data = nproc * gcd(2, 4) = 4
    mesh = make_mesh(n_data=4)
    state = replicate(mesh, state)
    text_table = replicate(mesh, jnp.asarray(text_table_np, jnp.float32))
    medium = replicate(mesh, jnp.asarray(medium_np))
    hard = replicate(mesh, jnp.asarray(hard_np))
    equivalence_j = replicate(mesh, jnp.asarray(equivalence_tensor))
    equiv_map_j = replicate(mesh, jnp.asarray(equiv_map))

    loss_cfg = HybridLossConfig()
    train_step = make_train_step(model, optimizer, loss_cfg, accum_steps=1)
    val_step = make_val_step(model, loss_cfg)
    curriculum = get_curriculum_schedule(1, 1)
    lr = make_lr_schedule("multi_step", [1e-3], [1])(0)

    def embed(batch):
        crops = prepare_image_crops(
            jnp.asarray(batch["image"]), jnp.asarray(batch["object_bbox"])
        )
        return np.asarray(image_provider(crops))

    for tl, _ in loaders:
        tl.set_epoch(1)
    # trainer: POSITIONAL per-step keys fold_in(key(seed + 1), step)
    # (round-5 bitwise-resume design, trainer.py)
    rng_root = jax.random.key(1)
    losses = []
    for step_i, (b0, b1) in enumerate(zip(*[tl for tl, _ in loaders])):
        if step_i >= n_steps:
            break
        step_batch = {
            "depth": np.stack(
                [np.concatenate([b0["depth"], b1["depth"]])]
            ).astype(np.float32),
            "segmentation": np.stack(
                [np.concatenate([b0["segmentation"], b1["segmentation"]])]
            ).astype(np.int32),
            "object_label": np.stack(
                [np.concatenate([b0["object_label"], b1["object_label"]])]
            ).astype(np.int32),
            "sample_valid": np.stack(
                [np.concatenate([b0["sample_valid"], b1["sample_valid"]])]
            ).astype(np.float32),
            "image_embeddings": np.stack(
                [np.concatenate([embed(b0), embed(b1)])]
            ).astype(np.float32),
        }
        step_batch = shard_batch(mesh, step_batch, batch_axis=1)
        step_rng = jax.random.fold_in(rng_root, step_i)
        state, info = train_step(
            state, step_batch, step_rng, jnp.float32(lr),
            jnp.float32(curriculum["pct_medium"]),
            jnp.float32(curriculum["pct_hard"]),
            text_table, medium, hard,
        )
        losses.append(float(info["total_loss"]))

    class _ZipVal:
        """Concatenated iteration of both processes' val-loader shards —
        the global batches the 2-process validation sees."""

        def __iter__(self):
            for v0, v1 in zip(loaders[0][1], loaders[1][1]):
                yield {
                    k: np.concatenate([v0[k], v1[k]]) for k in v0
                }

    best = validate_model(
        model, state.params, state.batch_stats, _ZipVal(),
        text_table, medium, hard, equivalence_j, equiv_map_j,
        curriculum, image_provider, n_steps,
        {"step": -1, "loss": float("inf")}, jax.random.key(999),
        loss_cfg, val_step_fn=val_step, mesh=mesh,
    )
    return losses, best


@pytest.mark.slow
def test_two_process_training_matches_single_process_simulation(tmp_path):
    data = write_synthetic_dataset(
        str(tmp_path / "data"), n_samples=16, shape=(32, 32), num_classes=8
    )
    port = _free_port()
    out_dir = str(tmp_path / "ckpt")

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")

    worker = os.path.join(TESTS_DIR, "multihost_worker.py")

    def run_workers(port):
        procs = [
            subprocess.Popen(
                [sys.executable, worker, str(i), "2", str(port),
                 str(tmp_path / "data"), out_dir],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )
            for i in range(2)
        ]
        # Drain both pipes CONCURRENTLY: the workers are coupled by gloo
        # collectives, so blocking on one's pipe while the other fills
        # its (undrained) pipe past the OS buffer would deadlock both.
        outputs = [None] * len(procs)

        def _drain(i, p):
            outputs[i] = p.communicate()[0]

        threads = [
            threading.Thread(target=_drain, args=(i, p), daemon=True)
            for i, p in enumerate(procs)
        ]
        for t in threads:
            t.start()
        # 1500 s: the two workers take ~330 s alone on this 1-core
        # machine but have timed out at 900 s under full-suite load
        # (compile-cache misses compound when other tests ran first)
        deadline = time.monotonic() + 1500
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        if any(t.is_alive() for t in threads):
            for p in procs:  # kill BOTH: no orphan keeps the coordinator
                p.kill()
            for t in threads:
                t.join(timeout=60)
            pytest.fail("multihost workers timed out (killed)")
        return procs, outputs

    procs, outputs = run_workers(port)
    # gloo's pair-connect can time out when this 1-core box is saturated
    # (observed once under full-suite load) — an infra flake, not a
    # semantics failure: retry ONCE on a fresh port before judging.
    if any(p.returncode != 0 for p in procs) and any(
        "Gloo context initialization failed" in (out or "")
        or "Connect timeout" in (out or "")
        for out in outputs
    ):
        procs, outputs = run_workers(_free_port())
    for i, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-4000:]}"

    bests = []
    for out in outputs:
        lines = [l for l in out.splitlines()
                 if l.startswith("MULTIHOST_BEST_JSON ")]
        assert lines, f"no best-results line in:\n{out[-2000:]}"
        bests.append(json.loads(lines[0].split(" ", 1)[1]))
    # both processes computed the same global validation results
    assert bests[0] == bests[1]
    real = bests[0]
    assert real["step"] == 2

    # host 0 wrote the logs; host 1 did not duplicate them
    assert os.path.exists(os.path.join(out_dir, "results.txt"))

    # the multihost checkpoint is restorable (weights-only)
    from rangeclip.training.checkpoint import CheckpointManager

    mgr = CheckpointManager(os.path.join(out_dir, "checkpoints"))
    assert mgr.latest_step() == 2
    params, _, step = mgr.restore_weights()
    assert step == 2
    n_params = sum(np.asarray(x).size for x in jax.tree.leaves(params))
    assert n_params > 0

    # the same global batches through the same step in ONE process agree
    sim_losses, sim_best = _simulate_single_process(data)
    # gloo vs single-process all-reduce ordering differs; fp32 tolerance
    for key in ("loss", "mIoU_t1", "mIoU_tk", "pixel_accuracy_t1",
                "pixel_accuracy_tk", "avg_text_contrastive_loss",
                "avg_image_contrastive_loss", "avg_smoothness_loss"):
        assert np.isclose(real[key], sim_best[key], rtol=2e-4, atol=1e-5), (
            key, real[key], sim_best[key]
        )
    # per-run average train loss at the step-2 checkpoint summary
    results_txt = open(os.path.join(out_dir, "results.txt")).read()
    assert "Begin training" in results_txt
    sim_avg = float(np.mean(sim_losses))
    import re

    m = re.search(r"Avg Loss: ([0-9.]+)", results_txt)
    assert m, results_txt[-2000:]
    assert np.isclose(float(m.group(1)), sim_avg, rtol=2e-4, atol=1e-5), (
        float(m.group(1)), sim_avg
    )
