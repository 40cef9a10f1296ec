#!/usr/bin/env bash
# Copy the round-5 convergence artifacts back into the repo.
# 22 optimizer steps/epoch (1200 samples ->
# 720 train / microbatch 8 // accum 4); LR boundaries at epochs 84/94 of
# 100 -> steps 1848/2068; the run ends at epoch 100 = step 2200.
set -euo pipefail
WORK=${1:-/tmp/convergence_r5}
DEST="$(dirname "$0")"
cp "$WORK/ckpt/tensorboard-train/events.csv" "$DEST/events-train.csv"
cp "$WORK/ckpt/tensorboard-val/events.csv" "$DEST/events-val.csv"
cp "$WORK/ckpt/results.txt" "$DEST/results.txt"
cp "$WORK/validate_test.log" "$DEST/validate_test.log" 2>/dev/null || true
