"""Streaming segmentation inference CLI.

Covers the inference-deployment configs in BASELINE.json: a pipelined
depth-map -> top-k-label-map path on one or more chips.  Depth PNGs stream
through a host prefetch thread (decode + median-normalize resize), the
device runs the fused forward+score+top-k program on fixed-shape batches,
and results stream back as label PNGs / npy files with colorized previews.

Usage:
  python -m rangeclip.cli.infer --checkpoint_dir ckpt/checkpoints \
    --depth_glob 'data/*_depth.png' --labels_path labels.csv \
    --output_dir out [--batch_size 8 --height 256 --width 256]
"""

from __future__ import annotations

import argparse
import glob
import os
import queue
import threading
import time

import numpy as np


def main(argv=None) -> None:
    from rangeclip.utils.platform import enable_compilation_cache
    enable_compilation_cache()
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint_dir", required=True)
    parser.add_argument("--depth_glob", required=True)
    parser.add_argument("--labels_path", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--height", type=int, default=256)
    parser.add_argument("--width", type=int, default=256)
    parser.add_argument("--top_k", type=int, default=5)
    parser.add_argument("--predict_path",
                        choices=("auto", "folded", "default"),
                        default="auto",
                        help="'folded' contracts the output conv with the "
                        "text table (same ranking, faster for small "
                        "candidate counts); 'default' is the "
                        "reference-parity scoring order; 'auto' folds "
                        "while the class count stays under the measured "
                        "~1.5x-embedding-dim crossover")
    parser.add_argument("--num_negatives", type=int, default=300)
    parser.add_argument("--embedding_dim", type=int, default=512)
    parser.add_argument("--unet_architecture", default="resnet",
                        help="resnet or mit (SegFormer-style encoder)")
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--clip_checkpoint_path", default=None)
    parser.add_argument("--clip_vocab_path", default=None)
    parser.add_argument("--clip_merges_path", default=None)
    parser.add_argument("--save_preview", action="store_true")
    args = parser.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from rangeclip.data.labels import load_candidate_labels
    from rangeclip.data.transforms import depth_transform
    from rangeclip.models.clip.provider import get_text_provider
    from rangeclip.models.depth_unet import (
        DepthUNet,
        DepthUNetConfig,
        folded_is_profitable,
    )
    from rangeclip.training.checkpoint import CheckpointManager
    from rangeclip.utils.visualization import colorize_segmentation, label_colors

    labels = load_candidate_labels(args.labels_path)
    num_classes = len(labels)

    text_provider = get_text_provider(
        args.clip_checkpoint_path, args.clip_vocab_path, args.clip_merges_path,
        dim=args.embedding_dim,
    )
    text_table = jnp.asarray(text_provider(labels), jnp.float32)

    cfg = DepthUNetConfig(
        unet_type=args.unet_architecture,
        embedding_dim=args.embedding_dim, use_batch_norm=True,
        dtype=jnp.bfloat16 if args.bf16 else None,
    )
    model = DepthUNet(cfg)
    # Weights-only restore: works for checkpoints from ANY training config
    # (weight decay / frozen-encoder change the opt_state pytree, which a
    # template-based restore would have to match — and inference discards).
    params, batch_stats, _ = CheckpointManager(
        args.checkpoint_dir).restore_weights()
    variables = {"params": params, "batch_stats": batch_stats}

    # Open-set streaming: no GT available, so candidates = ALL classes.
    candidate_mask = jnp.ones((num_classes,), bool)

    @jax.jit
    def predict(variables, depth):
        if args.predict_path == "folded" or (
            args.predict_path == "auto"
            and folded_is_profitable(num_classes, args.embedding_dim)
        ):
            # folded head (predict_folded): identical ranking, faster
            # while the candidate count stays under ~1.5x the embedding
            # dim (folded_is_profitable); bf16 near-ties may round
            # differently
            from rangeclip.models.depth_unet import predict_folded

            return predict_folded(model, variables, depth, text_table,
                                  top_k=args.top_k)
        topk, _, _ = model.apply(
            variables, depth, text_table, candidate_mask, args.top_k,
            method=DepthUNet.predict, return_embeddings=False,
        )
        return topk

    paths = sorted(glob.glob(args.depth_glob))
    os.makedirs(args.output_dir, exist_ok=True)
    colors = label_colors(num_classes)
    size = (args.height, args.width)

    q: "queue.Queue" = queue.Queue(maxsize=4)
    sentinel = object()

    from rangeclip.data.dataset import _open_gray

    producer_error = []

    def producer():
        try:
            batch, names = [], []
            for p in paths:
                depth = _open_gray(p).astype(np.float32)  # native fast path
                batch.append(depth_transform(depth, size)[..., None])
                names.append(os.path.splitext(os.path.basename(p))[0])
                if len(batch) == args.batch_size:
                    q.put((np.stack(batch), names))
                    batch, names = [], []
            if batch:  # pad the tail to the fixed shape
                n = len(batch)
                batch += [batch[0]] * (args.batch_size - n)
                q.put((np.stack(batch), names))
        except Exception as e:  # surfaced below; sentinel always lands
            producer_error.append(e)
        finally:
            q.put(sentinel)

    threading.Thread(target=producer, daemon=True).start()

    # Writer thread: PNG/npy encoding overlaps the next batch's device
    # dispatch instead of serializing with it.
    out_q: "queue.Queue" = queue.Queue(maxsize=4)
    n_done = 0

    writer_error = []

    def writer():
        nonlocal n_done
        from PIL import Image

        while True:
            item = out_q.get()
            if item is sentinel:
                return
            if writer_error:  # drain after failure so the main loop
                continue      # never blocks on a full queue
            topk, names = item
            try:
                for i, name in enumerate(names):
                    top1 = topk[i, :, :, 0]
                    np.save(os.path.join(args.output_dir, f"{name}_topk.npy"),
                            topk[i])
                    Image.fromarray(top1.astype(np.int32), mode="I").save(
                        os.path.join(args.output_dir, f"{name}_labels.png")
                    )
                    if args.save_preview:
                        rgb = (colorize_segmentation(top1, colors)
                               * 255).astype(np.uint8)
                        Image.fromarray(rgb).save(
                            os.path.join(args.output_dir,
                                         f"{name}_preview.png")
                        )
                n_done += len(names)
            except Exception as e:  # surfaced after join; keep draining
                writer_error.append(e)

    # Daemon: a crash in the main loop must not leave the process hung on
    # a non-daemon writer blocked in out_q.get().
    writer_thread = threading.Thread(target=writer, daemon=True)
    writer_thread.start()

    # One-deep device pipeline: dispatch batch N+1 (async under jax) before
    # fetching batch N's result, so device compute overlaps the D2H copy.
    t0 = time.perf_counter()
    pending = None
    try:
        while True:
            item = q.get()
            if item is sentinel:
                break
            depth_batch, names = item
            dev_topk = predict(variables, jnp.asarray(depth_batch))
            if pending is not None:
                out_q.put((np.asarray(pending[0]), pending[1]))
            pending = (dev_topk, names)
        if pending is not None:
            out_q.put((np.asarray(pending[0]), pending[1]))
    finally:
        out_q.put(sentinel)
        writer_thread.join()
    if producer_error:
        raise producer_error[0]
    if writer_error:
        raise writer_error[0]
    dt = time.perf_counter() - t0
    print(f"Segmented {n_done} depth maps in {dt:.2f}s "
          f"({n_done / max(dt, 1e-9):.1f} maps/s)")


if __name__ == "__main__":
    main()
