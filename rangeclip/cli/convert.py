"""Checkpoint migration CLI: reference ``.pth`` <-> this framework.

Makes the two-way weight migration (models/torch_interop.py) a first-class
entry point, so a user of the reference (jinryan/RangeCLIP) can bring a
trained ``depth_segmentation_model-*.pth`` here — or export a checkpoint
trained here back into a file the reference's ``DepthUNet.restore_model``
(model.py:380-393) loads.

  # reference .pth -> checkpoint directory (resumable by cli.train)
  python -m rangeclip.cli.convert \
      --from_pth depth_segmentation_model-4000.pth --checkpoint_path ckpt

  # checkpoint directory -> reference .pth
  python -m rangeclip.cli.convert \
      --checkpoint_dir ckpt/checkpoints --to_pth exported.pth

Optimizer state is not migrated in either direction: the torch Adam
moments have no meaning for optax (and the reference itself discards
restored optimizer state — train_util.py:152-166, a documented bug we fix
for our own checkpoints but cannot invert).  Imported checkpoints start
with fresh optimizer state at the checkpoint's train step.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--from_pth",
                        help="reference .pth to import (with --checkpoint_path)")
    parser.add_argument("--checkpoint_path",
                        help="destination root for the imported checkpoint "
                             "(a 'checkpoints/' dir is created inside, "
                             "matching cli.train)")
    parser.add_argument("--checkpoint_dir",
                        help="checkpoint dir to export (with --to_pth)")
    parser.add_argument("--to_pth", help="destination .pth file")
    parser.add_argument("--step", type=int, default=None,
                        help="checkpoint step to export (default: latest)")
    parser.add_argument("--unet_architecture", default="resnet")
    parser.add_argument("--embedding_dim", type=int, default=512)
    parser.add_argument("--encoder_filters", type=int, nargs=5, default=None,
                        help="override encoder widths (default: reference "
                             "32 64 128 256 512)")
    parser.add_argument("--n_height", type=int, default=224)
    parser.add_argument("--n_width", type=int, default=224)
    args = parser.parse_args(argv)

    importing = bool(args.from_pth)
    exporting = bool(args.to_pth)
    if importing == exporting:
        parser.error("exactly one of --from_pth / --to_pth is required")
    if importing and not args.checkpoint_path:
        parser.error("--from_pth requires --checkpoint_path")
    if exporting and not args.checkpoint_dir:
        parser.error("--to_pth requires --checkpoint_dir")

    import os

    import jax
    import numpy as np

    from rangeclip.models.depth_unet import DepthUNetConfig
    from rangeclip.training.checkpoint import CheckpointManager
    from rangeclip.training.optim import make_optimizer
    from rangeclip.training.state import create_train_state

    if importing:
        from rangeclip.models.torch_interop import load_reference_checkpoint

        cfg_kwargs = dict(unet_type=args.unet_architecture,
                          embedding_dim=args.embedding_dim, use_batch_norm=True)
        if args.encoder_filters:
            cfg_kwargs["encoder_filters"] = tuple(args.encoder_filters)
        cfg = DepthUNetConfig(**cfg_kwargs)
        template = create_train_state(
            jax.random.key(0), cfg, make_optimizer(0.0),
            (1, args.n_height, args.n_width, 1),
        )
        params, batch_stats, step = load_reference_checkpoint(args.from_pth)
        flat_t, treedef_t = jax.tree.flatten(template.params)
        flat_i, treedef_i = jax.tree.flatten(
            jax.tree.map(np.asarray, params))
        if treedef_t != treedef_i:
            raise SystemExit(
                "imported parameter tree does not match the model built from "
                "the given flags — check --unet_architecture/--embedding_dim/"
                f"--encoder_filters\n  model:    {treedef_t}\n"
                f"  imported: {treedef_i}")
        coerced = []
        for a, b in zip(flat_t, flat_i):
            if a.shape != b.shape and a.size == 1 and b.size == 1:
                # the reference stores the log-temperatures as [1] tensors
                # (model.py:77-78); our params are scalars.  Only
                # single-element leaves may be coerced — a size-equal shape
                # mismatch on a real kernel means permuted axes and must be
                # rejected below, not silently reshaped.
                b = b.reshape(a.shape)
            if a.shape != b.shape:
                raise SystemExit(
                    f"parameter shape mismatch: model {a.shape} vs imported "
                    f"{b.shape} — check the model flags")
            coerced.append(b)
        state = template.replace(
            step=np.int32(step),
            params=jax.tree.unflatten(treedef_t, coerced),
            batch_stats=batch_stats,
        )
        out_dir = os.path.join(args.checkpoint_path, "checkpoints")
        manager = CheckpointManager(out_dir)
        manager.save(state)
        manager.close()
        print(f"Imported {args.from_pth} (train_step={step}) -> {out_dir}")
        return

    # Export: raw weights-only restore — no opt_state template, so
    # checkpoints from ANY training config (weight decay, frozen-encoder
    # multi_transform, ...) export; the .pth carries no optimizer anyway.
    manager = CheckpointManager(args.checkpoint_dir)
    params, batch_stats, step = manager.restore_weights(step=args.step)
    manager.close()

    from rangeclip.models.torch_interop import save_reference_checkpoint

    save_reference_checkpoint(
        jax.tree.map(np.asarray, params),
        jax.tree.map(np.asarray, batch_stats),
        args.to_pth, train_step=step,
    )
    print(f"Exported step {step} -> {args.to_pth} "
          "(loadable by the reference's DepthUNet.restore_model)")


if __name__ == "__main__":
    main()
