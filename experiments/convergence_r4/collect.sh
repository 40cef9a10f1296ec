#!/usr/bin/env bash
# Copy the convergence run's artifacts back into the repo next to the
# config that produced them (run.sh).
# LR boundaries: epochs 48/56 of 60 at 11 optimizer steps per epoch
# (60/20/20 split -> 360 train images / microbatch 8 = 45 microbatches,
# // accumulation 4 -> 11 optimizer steps) -> steps 528, 616; the run
# ends at epoch 60 = step 660 (max_steps 900 is never reached).
set -euo pipefail
WORK=${1:-/tmp/convergence_r4}
DEST="$(dirname "$0")"
cp "$WORK/ckpt/tensorboard-train/events.csv" "$DEST/events-train.csv"
cp "$WORK/ckpt/tensorboard-val/events.csv" "$DEST/events-val.csv"
cp "$WORK/ckpt/results.txt" "$DEST/results.txt"
