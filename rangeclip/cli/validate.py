"""Standalone validation / baseline evaluation CLI.

Runs the equivalence-aware validation harness (and optionally the
majority/random/MaskCLIP baselines) over the held-out split of a dataset,
from a checkpoint — the reference's validate.py / evaluation.py entry
points as one command.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    from rangeclip.utils.platform import enable_compilation_cache
    enable_compilation_cache()
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--labeled_metadata_path", required=True)
    parser.add_argument("--labels_path", required=True)
    parser.add_argument("--equivalence_dict_path", required=True)
    parser.add_argument("--checkpoint_dir", required=True)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--n_height", type=int, default=224)
    parser.add_argument("--n_width", type=int, default=224)
    parser.add_argument("--split", choices=["val", "test"], default="val")
    parser.add_argument("--embedding_dim", type=int, default=512)
    parser.add_argument("--unet_architecture", default="resnet",
                        help="resnet or mit (SegFormer-style encoder)")
    parser.add_argument("--top_k", type=int, default=5)
    parser.add_argument("--num_negatives", type=int, default=50)
    parser.add_argument("--baselines", action="store_true",
                        help="also run majority/random baselines")
    parser.add_argument("--clip_checkpoint_path", default=None)
    parser.add_argument("--clip_vocab_path", default=None)
    parser.add_argument("--clip_merges_path", default=None)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

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
    from rangeclip.evals.baselines import (
        evaluate_majority_model,
        evaluate_random_model,
    )
    from rangeclip.evals.validate import validate_model
    from rangeclip.models.clip.provider import (
        get_image_provider,
        get_text_provider,
    )
    from rangeclip.models.depth_unet import DepthUNet, DepthUNetConfig
    from rangeclip.training.checkpoint import CheckpointManager
    from rangeclip.training.curriculum import get_curriculum_schedule

    _, val_loader, test_loader, _, labels = setup_dataloaders(
        args.labeled_metadata_path, args.labels_path,
        (args.n_height, args.n_width), args.batch_size, n_epoch=1,
    )
    loader = val_loader if args.split == "val" else test_loader
    num_classes = len(labels)

    eq_dict = load_equivalence_dict(args.equivalence_dict_path)
    eq_tensor = build_equivalence_tensor(eq_dict, num_classes)
    eq_map = build_equivalence_class_map(eq_tensor)
    sim_sets = load_label_similarity_sets(args.equivalence_dict_path, num_classes)
    medium, hard = build_similarity_matrices(sim_sets, num_classes)

    text_provider = get_text_provider(
        args.clip_checkpoint_path, args.clip_vocab_path, args.clip_merges_path,
        dim=args.embedding_dim,
    )
    image_provider = get_image_provider(args.clip_checkpoint_path,
                                        dim=args.embedding_dim)
    text_table = jnp.asarray(text_provider(labels), jnp.float32)

    cfg = DepthUNetConfig(unet_type=args.unet_architecture,
                          embedding_dim=args.embedding_dim, use_batch_norm=True)
    model = DepthUNet(cfg)
    # Weights-only restore — independent of the training run's optimizer
    # structure (weight decay / frozen-encoder), which validation discards.
    params, batch_stats, step = CheckpointManager(
        args.checkpoint_dir).restore_weights()

    best = validate_model(
        model, params, batch_stats, loader,
        text_table, jnp.asarray(medium), jnp.asarray(hard),
        jnp.asarray(eq_tensor), jnp.asarray(eq_map),
        get_curriculum_schedule(1, 1), image_provider,
        step, {"step": -1, "loss": float("inf")}, jax.random.key(args.seed),
        top_k=args.top_k, num_negatives=args.num_negatives,
    )
    print(f"Validation results @ step {step}: {best}")

    if args.baselines:
        seg_counts = np.zeros(num_classes, np.int64)
        for batch in loader:
            # exclude pad duplicates (sample_valid=0) from the majority count
            valid = np.asarray(batch.get(
                "sample_valid", np.ones(len(batch["segmentation"])))) > 0
            vals, counts = np.unique(
                np.asarray(batch["segmentation"])[valid], return_counts=True)
            seg_counts[vals] += counts
        majority = int(seg_counts.argmax())
        evaluate_majority_model(loader, majority, eq_tensor, eq_map, num_classes)
        evaluate_random_model(loader, num_classes, eq_tensor, eq_map)


if __name__ == "__main__":
    main()
