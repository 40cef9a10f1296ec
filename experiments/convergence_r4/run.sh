#!/usr/bin/env bash
# Canonical-scale convergence run (VERDICT r3 "Next round" #1).
#
# Everything needed to reproduce the committed artifact lives in THIS
# script: the on-disk dataset parameters, every training flag, and the
# seeds.  The run goes through the real CLI + on-disk PNG dataset
# (data/synthetic.py write_synthetic_dataset -> cli/train.py), exercising
# the full loader/decode path, with the frozen CLIP image tower ON
# (--clip_checkpoint_path random = the real ViT-B/32 vision tower with
# deterministic random weights; the text tower is the deterministic hash
# embedder -- no external checkpoints exist in this environment).
#
# Schedule design: multi-step LR holds 2e-4 for 48 of 60 epochs (first
# boundary at optimizer step 528 of 660 -- 11 opt steps/epoch from the
# 60/20/20 split of 600 samples at microbatch 8 x accum 4) so the val
# metrics are still descending when the boundary hits -- the round-3
# run's mistake was dropping 10x at 1/3 of the run.  Curriculum sweeps
# pct_medium 1->0 by epoch 15 and pct_hard 0->0.8 by epoch 40
# (train_util.py:52-62 law).  max_steps 900 is a safety cap, not reached.
#
# Usage (GPU machine):   bash experiments/convergence_r4/run.sh [workdir]
# Artifacts are copied back into experiments/convergence_r4/ afterwards
# by collect.sh.
set -euo pipefail
WORK=${1:-/tmp/convergence_r4}
mkdir -p "$WORK"

# --- on-disk dataset (recorded provenance) -----------------------------
python - "$WORK" <<'EOF'
import sys
from rangeclip.data.synthetic import write_synthetic_dataset

paths = write_synthetic_dataset(
    sys.argv[1] + "/data",
    n_samples=600,        # deterministic 60/20/20 split (seed-42 law)
    shape=(224, 224),     # canonical training resolution
    num_classes=256,      # C=256 (255 candidate labels + 'unavailable')
    seed=11,
    n_regions=10,         # 10 Voronoi objects above the floor band
)
print(paths)
EOF

# --- training through the real CLI -------------------------------------
python -m rangeclip.cli.train \
  --labeled_metadata_path "$WORK/data/metadata.csv" \
  --labels_path "$WORK/data/candidate_labels.csv" \
  --equivalence_dict_path "$WORK/data/label_similarity_sets.csv" \
  --unet_architecture resnet \
  --batch_size 8 --n_height 224 --n_width 224 \
  --accumulation_steps 4 \
  --learning_rates 2e-4 2e-5 2e-6 \
  --learning_schedule 48 56 60 \
  --scheduler_type multi_step \
  --w_weight_decay 0.0 \
  --w_text 1.0 --w_image 0.5 --w_smooth 2e2 \
  --clip_checkpoint_path random \
  --embedding_dim 512 \
  --checkpoint_path "$WORK/ckpt" \
  --n_step_per_checkpoint 300 \
  --n_step_per_summary 15 \
  --n_step_per_validation 45 \
  --validation_start_step 45 \
  --max_steps 900 \
  --bf16 \
  --seed 0 \
  2>&1 | tee "$WORK/train.log"
