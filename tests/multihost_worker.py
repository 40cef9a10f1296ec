"""Worker entry for the real 2-process distributed training test.

Launched by tests/test_multihost.py as ``python multihost_worker.py
<process_id> <num_processes> <port> <data_dir> <out_dir>`` with
JAX_PLATFORMS=cpu and 4 virtual CPU devices per process.  Runs the ACTUAL
trainer (rangeclip.training.trainer) under ``jax.distributed`` — the
reference's torchrun/DDP launch shape (train.py:15-19), one loader shard
per process — and prints the final best-results dict as JSON for the
parent to compare against a single-process simulation of the same global
batches.

Everything lives under ``main()`` — the loader's forkserver worker pool
preloads ``__main__``, so module-level work would re-run in the pool
helper (same reason every torch DataLoader script needs the guard).
"""

import json
import sys


def main() -> None:
    proc_id = int(sys.argv[1])
    nproc = int(sys.argv[2])
    port = sys.argv[3]
    data_dir = sys.argv[4]
    out_dir = sys.argv[5]

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        f"localhost:{port}", num_processes=nproc, process_id=proc_id
    )
    # match tests/conftest.py numerics so the parent-process simulation is
    # comparable
    jax.config.update("jax_default_matmul_precision", "highest")

    from rangeclip.training.trainer import (
        TrainerConfig,
        train_depth_clip_model,
    )

    cfg = TrainerConfig(
        labeled_metadata_path=f"{data_dir}/metadata.csv",
        labels_path=f"{data_dir}/candidate_labels.csv",
        equivalence_dict_path=f"{data_dir}/label_similarity_sets.csv",
        batch_size=2,  # per process — global microbatch 4
        n_height=32,
        n_width=32,
        unet_architecture="resnet",
        learning_rates=[1e-3],
        learning_schedule=[1],
        scheduler_type="multi_step",
        w_weight_decay=1e-4,
        checkpoint_path=out_dir,
        n_step_per_checkpoint=2,
        n_step_per_summary=2,
        n_sample_per_summary=0,
        validation_start_step=2,
        accumulation_steps=1,
        embedding_dim=32,
        max_steps=2,
        encoder_filters=(8, 16, 16, 16, 32),
    )
    best = train_depth_clip_model(cfg)
    print(f"MULTIHOST_BEST_JSON {json.dumps(best)}", flush=True)


if __name__ == "__main__":
    main()
