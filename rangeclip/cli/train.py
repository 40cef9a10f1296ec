"""Training CLI.

Mirrors the reference's flag surface (train.py:24-82) with JAX
replacements: no torchrun — multi-host launch is
``jax.distributed.initialize`` driven by the flags; on a single host
all local devices are used automatically via the mesh.

Usage:
  python -m rangeclip.cli.train \
    --labeled_metadata_path data/sunrgbd/metadata.csv \
    --labels_path data/sunrgbd/candidate_labels.csv \
    --equivalence_dict_path data/sunrgbd/label_similarity_sets.csv \
    --checkpoint_path checkpoints --unet_architecture resnet
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)

    # Training and validation input filepaths (train.py:27-33)
    parser.add_argument("--labeled_metadata_path", type=str, required=True,
                        help="Path to labeled dataset metadata.csv")
    parser.add_argument("--labels_path", type=str, required=True,
                        help="Path to dataset labels CSV")
    parser.add_argument("--equivalence_dict_path", type=str, required=True,
                        help="Path to equivalence/similarity-sets CSV")

    # Batch parameters (train.py:36-41)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--n_height", type=int, default=128)
    parser.add_argument("--n_width", type=int, default=128)

    # Network settings (train.py:44-48)
    parser.add_argument("--unet_architecture", type=str, required=True,
                        help="UNet encoder architecture, e.g. resnet")
    parser.add_argument("--clip_checkpoint_path", type=str, default=None,
                        help="HF CLIP checkpoint (.bin/.safetensors) for the "
                             "frozen towers; omit to use deterministic stubs")
    parser.add_argument("--clip_vocab_path", type=str, default=None)
    parser.add_argument("--clip_merges_path", type=str, default=None)

    # Training settings (train.py:51-57)
    parser.add_argument("--learning_rates", nargs="+", type=float,
                        default=[2e-4, 1e-4, 5e-5, 1e-5])
    parser.add_argument("--scheduler_type", type=str, default="multi_step",
                        help="multi_step, cosine_annealing, reduce_on_plateau")
    parser.add_argument("--learning_schedule", nargs="+", type=int,
                        default=[10, 20, 30, 35])

    # Loss settings (train.py:60-61 + train_util.py:88-91 defaults)
    parser.add_argument("--w_weight_decay", type=float, default=0.0)
    parser.add_argument("--w_text", type=float, default=1.0)
    parser.add_argument("--w_image", type=float, default=0.5)
    parser.add_argument("--w_smooth", type=float, default=2e2)
    parser.add_argument(
        "--class_balanced", action="store_true",
        help="Rescale pixel-text CE weights so every present class "
        "contributes equal total weight per window (opt-in divergence "
        "from the reference's uniform pixel sampling; counters dominant-"
        "class gradient dilution — see HybridLossConfig.class_balanced).")
    parser.add_argument("--accumulation_steps", type=int, default=8)

    # Checkpointing and logging (train.py:64-77)
    parser.add_argument("--checkpoint_path", type=str, required=True)
    parser.add_argument("--n_step_per_checkpoint", type=int, default=5000)
    parser.add_argument("--n_step_per_summary", type=int, default=1000)
    parser.add_argument("--n_step_per_validation", type=int, default=None,
                        help="Validation cadence; default: every "
                             "--n_step_per_summary (reference behavior)")
    parser.add_argument("--n_sample_per_summary", type=int, default=4)
    parser.add_argument("--validation_start_step", type=int, default=5000)
    parser.add_argument("--restore_path_model", type=str, default=None)
    parser.add_argument("--auto_resume", action="store_true",
                        help="resume from the latest checkpoint in "
                             "checkpoint_path if one exists (preemption "
                             "recovery)")
    parser.add_argument("--restore_path_encoder", type=str, default=None)
    parser.add_argument("--freeze_encoder", action="store_true", default=None,
                        help="freeze the depth encoder (eval-mode BN, zero "
                             "updates); defaults to ON when "
                             "--restore_path_encoder is given "
                             "(train_util.py:158 semantics)")
    parser.add_argument("--no_freeze_encoder", dest="freeze_encoder",
                        action="store_false",
                        help="finetune the restored encoder instead")

    parser.add_argument("--embedding_dim", type=int, default=512,
                        help="joint embedding dim; must match the CLIP "
                             "projection_dim when real CLIP weights are used")

    # Hardware settings
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute policy (fp32 params)")
    parser.add_argument("--ddp_parity", action="store_true",
                        help="reference-exact multi-device semantics: "
                             "per-replica BN statistics and per-rank losses "
                             "over local batch shards, gradients pmean'd "
                             "(torch DDP, train_util.py:338) instead of the "
                             "default global-batch sync-BN formulation")
    parser.add_argument("--max_steps", type=int, default=None,
                        help="stop after N optimizer steps (smoke runs)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a jax.profiler trace of train steps 2-4")
    parser.add_argument("--distributed", action="store_true",
                        help="call jax.distributed.initialize() (multi-host)")
    parser.add_argument("--coordinator_address", type=str, default=None,
                        help="host:port of process 0's coordinator for "
                             "--distributed outside a managed cluster "
                             "(where initialize() auto-detects)")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--encoder_filters", nargs="+", type=int, default=None,
                        help="encoder channel widths (default: the "
                             "reference's ResNet-18 widths); small values "
                             "for smoke drives")
    return parser


def main(argv=None) -> None:
    from rangeclip.utils.platform import enable_compilation_cache
    enable_compilation_cache()
    args = build_parser().parse_args(argv)
    assert len(args.learning_rates) == len(args.learning_schedule), (
        "Mismatch in learning rates and schedule lengths"
    )

    if args.distributed:
        import jax

        if args.coordinator_address:
            jax.distributed.initialize(
                coordinator_address=args.coordinator_address,
                num_processes=args.num_processes,
                process_id=args.process_id,
            )
        else:
            assert args.num_processes is None and args.process_id is None, (
                "--num_processes/--process_id have no effect without "
                "--coordinator_address (outside a managed cluster all "
                "three must be given together)"
            )
            jax.distributed.initialize()  # managed-cluster auto-detect

    from rangeclip.training.trainer import TrainerConfig, train_depth_clip_model

    cfg = TrainerConfig(
        labeled_metadata_path=args.labeled_metadata_path,
        labels_path=args.labels_path,
        equivalence_dict_path=args.equivalence_dict_path,
        batch_size=args.batch_size,
        n_height=args.n_height,
        n_width=args.n_width,
        unet_architecture=args.unet_architecture,
        learning_rates=args.learning_rates,
        learning_schedule=args.learning_schedule,
        scheduler_type=args.scheduler_type,
        w_weight_decay=args.w_weight_decay,
        checkpoint_path=args.checkpoint_path,
        n_step_per_checkpoint=args.n_step_per_checkpoint,
        n_step_per_summary=args.n_step_per_summary,
        n_step_per_validation=args.n_step_per_validation,
        n_sample_per_summary=args.n_sample_per_summary,
        validation_start_step=args.validation_start_step,
        restore_path_model=args.restore_path_model,
        restore_path_encoder=args.restore_path_encoder,
        freeze_encoder=args.freeze_encoder,
        clip_checkpoint_path=args.clip_checkpoint_path,
        clip_vocab_path=args.clip_vocab_path,
        clip_merges_path=args.clip_merges_path,
        accumulation_steps=args.accumulation_steps,
        embedding_dim=args.embedding_dim,
        w_text=args.w_text,
        w_image=args.w_image,
        w_smooth=args.w_smooth,
        class_balanced=args.class_balanced,
        bf16=args.bf16,
        ddp_parity=args.ddp_parity,
        seed=args.seed,
        max_steps=args.max_steps,
        auto_resume=args.auto_resume,
        profile_dir=args.profile_dir,
        encoder_filters=args.encoder_filters,
    )
    best = train_depth_clip_model(cfg)
    print(f"Best results: {best}")


if __name__ == "__main__":
    main()
