"""Serialize the inference program to a StableHLO deployment artifact.

``jax.export`` freezes the jitted predict program — model weights, the
candidate-label text table, and the whole fused forward+score+top-k
pipeline — into one self-contained, versioned StableHLO blob that any
later process (or a C++/serving runtime embedding PJRT) can load and run
without Python model code, checkpoint directories, or retracing.  This is
the deployment counterpart to ``cli.convert`` (which moves *weights*
between frameworks); here the *program* ships.

The reference has no analogue (its deployment story is "keep the Python
around", model.py:368-393); a serialized artifact hands inference to a
serving fleet.

Signature of the exported function (static shapes, NHWC):

    depth [B, H, W, 1] f32  ->  top-k labels [B, H, W, k] i32

With ``--text_as_input`` the candidate table becomes a runtime argument
``(depth, text [C, D] f32)`` instead of a baked constant, so one artifact
serves any open-vocabulary label set of that size (the fold of the output
conv with the table happens inside the program, per call).

Portability: the program is plain XLA (no custom calls), lowered for the
current backend by default.  ``--portable`` lowers one artifact for both
the CPU and CUDA backends; ``--platforms`` names the backends explicitly
(``jax.export`` lowers for a platform the exporting host lacks).

Usage:
  python -m rangeclip.cli.export --checkpoint_dir ckpt/checkpoints \
    --labels_path labels.csv --output model.stablehlo \
    [--batch_size 8 --height 256 --width 256 --top_k 5] \
    [--predict_path auto|folded|default] [--text_as_input] \
    [--portable | --platforms cpu cuda] [--verify]
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint_dir", default=None,
                        help="checkpoint dir; omit with --init_random")
    parser.add_argument("--init_random", action="store_true",
                        help="export a randomly initialized model (smoke "
                        "tests / pipeline dry-runs, no checkpoint needed)")
    parser.add_argument("--labels_path", default=None,
                        help="candidate labels CSV; embeds real CLIP text "
                        "embeddings (or the deterministic stub) in the "
                        "artifact")
    parser.add_argument("--num_classes", type=int, default=None,
                        help="class count when --labels_path is omitted "
                        "(required with --text_as_input)")
    parser.add_argument("--output", required=True,
                        help="artifact path; a <output>.json sidecar "
                        "records the signature and provenance")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--height", type=int, default=256)
    parser.add_argument("--width", type=int, default=256)
    parser.add_argument("--top_k", type=int, default=5)
    parser.add_argument("--predict_path",
                        choices=("auto", "folded", "default"),
                        default="auto",
                        help="'folded' contracts the output conv with the "
                        "text table (same ranking, faster under the "
                        "~1.5x-embedding-dim class-count crossover); "
                        "'default' is the reference-parity scoring order; "
                        "'auto' picks by the measured crossover")
    parser.add_argument("--text_as_input", action="store_true",
                        help="take the [C, D] text table as a runtime "
                        "argument instead of baking it in")
    parser.add_argument("--portable", action="store_true",
                        help="lower for both cpu and cuda (default "
                        "--platforms of a portable artifact)")
    parser.add_argument("--platforms", nargs="*", default=None,
                        help="lowering platforms (e.g. cpu cuda); default: "
                        "the current backend")
    parser.add_argument("--verify", action="store_true",
                        help="deserialize the artifact and check its "
                        "output matches the live function on the current "
                        "backend")
    parser.add_argument("--embedding_dim", type=int, default=512)
    parser.add_argument("--encoder_filters", nargs="*", type=int,
                        default=None,
                        help="override the encoder filter widths (must "
                        "match the checkpoint's model)")
    parser.add_argument("--unet_architecture", default="resnet",
                        help="resnet or mit (SegFormer-style encoder)")
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--clip_checkpoint_path", default=None)
    parser.add_argument("--clip_vocab_path", default=None)
    parser.add_argument("--clip_merges_path", default=None)
    args = parser.parse_args(argv)

    if args.checkpoint_dir is None and not args.init_random:
        parser.error("either --checkpoint_dir or --init_random is required")
    if args.labels_path is None and args.num_classes is None:
        parser.error("either --labels_path or --num_classes is required")

    from rangeclip.utils.platform import enable_compilation_cache
    enable_compilation_cache()

    import jax
    import jax.numpy as jnp
    from jax import export as jax_export

    from rangeclip.models.depth_unet import (
        DepthUNet,
        DepthUNetConfig,
        folded_is_profitable,
        predict_folded,
    )

    if args.labels_path is not None:
        from rangeclip.data.labels import load_candidate_labels
        from rangeclip.models.clip.provider import get_text_provider

        labels = load_candidate_labels(args.labels_path)
        num_classes = len(labels)
        text_provider = get_text_provider(
            args.clip_checkpoint_path, args.clip_vocab_path,
            args.clip_merges_path, dim=args.embedding_dim,
        )
        text_np = text_provider(labels)
    else:
        num_classes = args.num_classes
        text_np = None

    cfg_kwargs = {}
    if args.encoder_filters:
        cfg_kwargs["encoder_filters"] = tuple(args.encoder_filters)
    cfg = DepthUNetConfig(
        unet_type=args.unet_architecture,
        embedding_dim=args.embedding_dim, use_batch_norm=True,
        dtype=jnp.bfloat16 if args.bf16 else None,
        **cfg_kwargs,
    )
    model = DepthUNet(cfg)

    depth_shape = (args.batch_size, args.height, args.width, 1)
    if args.init_random:
        variables = jax.jit(
            lambda k, d: model.init(k, d, train=False)
        )(jax.random.key(0), jnp.zeros(depth_shape, jnp.float32))
    else:
        from rangeclip.training.checkpoint import CheckpointManager

        params, batch_stats, _ = CheckpointManager(
            args.checkpoint_dir).restore_weights()
        variables = {"params": params, "batch_stats": batch_stats}

    folded = args.predict_path == "folded" or (
        args.predict_path == "auto"
        and folded_is_profitable(num_classes, args.embedding_dim)
    )
    candidate_mask = jnp.ones((num_classes,), bool)

    def predict(depth, text):
        if folded:
            return predict_folded(model, variables, depth, text,
                                  top_k=args.top_k)
        topk, _, _ = model.apply(
            variables, depth, text, candidate_mask, args.top_k,
            method=DepthUNet.predict, return_embeddings=False,
        )
        return topk

    if args.text_as_input:
        fn = predict
    else:
        if text_np is None:
            parser.error("--num_classes without --labels_path requires "
                         "--text_as_input (there is no table to bake in)")
        text_const = jnp.asarray(text_np, jnp.float32)
        fn = lambda depth: predict(depth, text_const)  # noqa: E731

    # jax.export names the GPU backend by its runtime, "cuda"
    backend = {"gpu": "cuda"}.get(jax.default_backend(), jax.default_backend())
    platforms = args.platforms or (["cpu", "cuda"] if args.portable
                                   else [backend])
    export_kwargs = {}
    if platforms != [backend]:
        export_kwargs["platforms"] = platforms

    example = [jnp.zeros(depth_shape, jnp.float32)]
    if args.text_as_input:
        example.append(jnp.zeros((num_classes, args.embedding_dim),
                                 jnp.float32))
    exported = jax_export.export(jax.jit(fn), **export_kwargs)(*example)
    blob = exported.serialize()
    with open(args.output, "wb") as f:
        f.write(blob)

    sidecar = {
        "format": "jax.export serialized StableHLO",
        "jax_version": jax.__version__,
        "calling_convention_version": exported.calling_convention_version,
        "platforms": list(exported.platforms),
        "inputs": [{"shape": list(a.shape), "dtype": str(a.dtype)}
                   for a in example],
        "output": {"shape": [args.batch_size, args.height, args.width,
                             args.top_k], "dtype": "int32"},
        "num_classes": num_classes,
        "embedding_dim": args.embedding_dim,
        "top_k": args.top_k,
        "predict_path": "folded" if folded else "default",
        "text_as_input": bool(args.text_as_input),
        "portable": bool(args.portable),
        "unet_architecture": args.unet_architecture,
        "bf16": bool(args.bf16),
        "bytes": len(blob),
    }
    with open(args.output + ".json", "w") as f:
        json.dump(sidecar, f, indent=2)

    print(f"Exported {len(blob) / 1e6:.2f} MB to {args.output} "
          f"(platforms {','.join(exported.platforms)}, "
          f"{'folded' if folded else 'default'} path"
          f"{', text as input' if args.text_as_input else ''})")

    if args.verify:
        if backend not in [p.lower() for p in exported.platforms]:
            raise SystemExit(
                f"--verify needs the current backend "
                f"({backend}) among the exported platforms "
                f"{list(exported.platforms)}")
        rng = jax.random.key(7)
        depth = jax.random.normal(rng, depth_shape, jnp.float32)
        call_args = [depth]
        if args.text_as_input:
            call_args.append(jax.random.normal(
                jax.random.key(8), (num_classes, args.embedding_dim),
                jnp.float32))
        restored = jax_export.deserialize(blob)
        got = jax.device_get(restored.call(*call_args))
        want = jax.device_get(jax.jit(fn)(*call_args))
        if (got != want).any():
            raise SystemExit("verify FAILED: deserialized artifact disagrees "
                             "with the live function")
        print(f"verify OK: {got.size} labels bit-identical to the live "
              "function")


if __name__ == "__main__":
    main()
