#!/bin/bash
# Canonical training launcher (the reference's train_segmentation_model.sh
# equivalent).  No torchrun: a single process drives every local GPU
# through the mesh; multi-host runs add --distributed and launch one process
# per host.

# Paths
labeled_metadata_path="data/sunrgbd/SUNRGBD/metadata.csv"
labels_path="data/sunrgbd/SUNRGBD/candidate_labels.csv"
equivalence_dict_path="data/sunrgbd/SUNRGBD/label_similarity_sets.csv"

# Frozen CLIP (supply the HF openai/clip-vit-base-patch32 artifacts; when
# omitted the deterministic stub embedders keep the pipeline runnable)
clip_checkpoint_path=""
clip_vocab_path=""
clip_merges_path=""

# Training & model config (launcher parity: batch 2, 224x224, MultiStep)
batch_size=2
n_height=224
n_width=224
unet_architecture="resnet"
learning_rates=(2e-4 1e-4 5e-5 1e-5)
learning_schedule=(10 20 30 35)
scheduler_type="multi_step"
w_weight_decay=1e-4

# Checkpoint & logging
checkpoint_path="checkpoints"
n_step_per_checkpoint=1000
n_step_per_summary=500
n_sample_per_summary=32
validation_start_step=5000
restore_path_model=""
restore_path_encoder=""

extra_flags=()
[ -n "$clip_checkpoint_path" ] && extra_flags+=(--clip_checkpoint_path "$clip_checkpoint_path" \
  --clip_vocab_path "$clip_vocab_path" --clip_merges_path "$clip_merges_path")
[ -n "$restore_path_model" ] && extra_flags+=(--restore_path_model "$restore_path_model")
[ -n "$restore_path_encoder" ] && extra_flags+=(--restore_path_encoder "$restore_path_encoder")

python -m rangeclip.cli.train \
    --labeled_metadata_path "$labeled_metadata_path" \
    --labels_path "$labels_path" \
    --equivalence_dict_path "$equivalence_dict_path" \
    --batch_size $batch_size \
    --n_height $n_height \
    --n_width $n_width \
    --unet_architecture $unet_architecture \
    --learning_rates "${learning_rates[@]}" \
    --learning_schedule "${learning_schedule[@]}" \
    --scheduler_type $scheduler_type \
    --w_weight_decay $w_weight_decay \
    --checkpoint_path "$checkpoint_path" \
    --n_step_per_checkpoint $n_step_per_checkpoint \
    --n_step_per_summary $n_step_per_summary \
    --n_sample_per_summary $n_sample_per_summary \
    --validation_start_step $validation_start_step \
    --bf16 \
    "${extra_flags[@]}"
