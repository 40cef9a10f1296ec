"""Benchmark CLI: throughput + robustness sweep.

``throughput`` measures (a) the 256^2 inference path (maps/sec/device) and
(b) the contrastive train-step time — the two BASELINE.json metrics — at
several batch sizes, in fp32 and bf16.

``robustness`` runs the brightness/saturation sweep (the reference's
benchmark/segclip.py equivalent) with the depth model from a checkpoint.
"""

from __future__ import annotations

import argparse
import json
import time


def cmd_throughput(args) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rangeclip.losses.hybrid import HybridLossConfig
    from rangeclip.models.depth_unet import (
        DepthUNet,
        DepthUNetConfig,
        build_candidate_mask,
        folded_is_profitable,
    )
    from rangeclip.training.optim import make_optimizer
    from rangeclip.training.state import create_train_state
    from rangeclip.training.train_step import make_train_step
    from rangeclip.utils.roofline import jaxpr_matmul_flops

    res, C, D = args.resolution, args.num_classes, 512
    results = []
    for bf16 in ([False, True] if args.both_precisions else [args.bf16]):
        cfg = DepthUNetConfig(unet_type=args.unet_architecture,
                              use_batch_norm=True,
                              dtype=jnp.bfloat16 if bf16 else None)
        model = DepthUNet(cfg)
        for batch in args.batch_sizes:
            depth = jnp.zeros((batch, res, res, 1), jnp.float32)
            # jitted init: eager init dispatches hundreds of tiny ops
            variables = jax.jit(
                lambda k, d: model.init(k, d, train=False)
            )(jax.random.key(0), depth)
            text = jax.random.normal(jax.random.key(1), (C, D))
            seg = jax.random.randint(jax.random.key(2), (batch, res, res), 0, 40)
            cand = build_candidate_mask(jax.random.key(3), seg, C, 300)

            @jax.jit
            def predict(variables, depth):
                if args.predict_path == "folded" or (
                    args.predict_path == "auto"
                    and folded_is_profitable(C, D)
                ):
                    from rangeclip.models.depth_unet import predict_folded

                    return predict_folded(model, variables, depth, text,
                                          candidate_mask=cand, top_k=5)
                return model.apply(variables, depth, text, cand, 5,
                                   method=DepthUNet.predict)[0]

            jax.block_until_ready(predict(variables, depth))
            # best-of rounds
            dt = float("inf")
            for _ in range(args.rounds):
                t0 = time.perf_counter()
                for _ in range(args.iters):
                    out = predict(variables, depth)
                jax.block_until_ready(out)
                dt = min(dt, time.perf_counter() - t0)
            results.append({
                "mode": "inference", "precision": "bf16" if bf16 else "fp32",
                "batch": batch, "resolution": res,
                "maps_per_sec": round(batch * args.iters / dt, 2),
                "ms_per_batch": round(1e3 * dt / args.iters, 3),
            })

        if not args.train_configs:
            continue
        text = jax.random.normal(jax.random.key(1), (C, D))
        med = jnp.zeros((C, C), bool)
        opt = make_optimizer(1e-4)
        # multiple (accum x microbatch) configs and samplers A/B within ONE
        # process: comparisons across processes carry more noise
        for config in args.train_configs:
            A, B = (int(v) for v in config.split("x"))
            state = create_train_state(jax.random.key(0), cfg, opt,
                                       (B, res, res, 1))
            rngnp = np.random.default_rng(0)
            # device-resident batch: timing must measure the step program,
            # not a per-iteration host->device re-transfer — the inference
            # timings above are device-only too
            batch_data = jax.tree.map(jnp.asarray, {
                "depth": rngnp.standard_normal((A, B, res, res, 1)).astype(np.float32),
                "segmentation": rngnp.integers(0, 40, (A, B, res, res)).astype(np.int32),
                "object_label": np.ones((A, B), np.int32),
                "image_embeddings": rngnp.standard_normal((A, B, D)).astype(np.float32),
                "sample_valid": np.ones((A, B), np.float32),
            })

            tower_flops = 0.0
            tower_step = None
            if args.with_image_tower:
                # The frozen CLIP image tower IN the
                # measured loop — real ViT-B/32 shape (random weights cost
                # the same FLOPs as converted ones), one crop-extraction +
                # tower call per accumulation window exactly as the
                # trainer dispatches it (trainer._make_window_tower),
                # embeddings device-resident end to end.
                import dataclasses as _dc

                from rangeclip.models.clip.crops import (
                    prepare_image_crops,
                )
                from rangeclip.models.clip.model import (
                    CLIP_VIT_B32, CLIPVisionTower,
                )

                tcfg = _dc.replace(
                    CLIP_VIT_B32,
                    dtype=jnp.bfloat16 if bf16 else None)
                tower = CLIPVisionTower(tcfg)
                crop0 = jnp.zeros((A * B, 224, 224, 3), jnp.float32)
                tower_params = jax.jit(tower.init)(jax.random.key(9), crop0)
                images = jnp.asarray(rngnp.random(
                    (A * B, res, res, 3), np.float32))
                xy = rngnp.integers(0, res // 2, (A * B, 2))
                bboxes = jnp.asarray(np.concatenate(
                    [xy, xy + rngnp.integers(16, res // 2, (A * B, 2))],
                    axis=1).astype(np.int32))

                @jax.jit
                def window_tower(tower_params, images, bboxes):
                    crops = prepare_image_crops(images, bboxes)
                    embs = tower.apply(tower_params, crops)
                    return embs.reshape(A, B, -1).astype(jnp.float32)

                tower_step = lambda: window_tower(tower_params, images,
                                                  bboxes)
                tower_flops = float(jaxpr_matmul_flops(jax.make_jaxpr(
                    window_tower)(tower_params, images, bboxes)))

            for sampler in args.pixel_sampler:
                step = make_train_step(
                    model, opt, HybridLossConfig(pixel_sampler=sampler),
                    accum_steps=A,
                )

                # FLOP ledger: convolution and matmul FLOPs counted from
                # the step's jaxpr, as bench.py counts predict (XLA's
                # cost_analysis misses the cuDNN convolutions on the GPU);
                # HLO bytes accessed for the memory-bandwidth roofline
                step_args = (state, batch_data, jax.random.key(5),
                             jnp.float32(1e-4), jnp.float32(0.25),
                             jnp.float32(0.5), text, med, med)
                step_flops = float(jaxpr_matmul_flops(
                    jax.make_jaxpr(step)(*step_args)))
                step_cost = step.lower(*step_args).compile().cost_analysis()
                # XLA's cost_analysis counts the accumulation lax.scan BODY
                # ONCE regardless of trip count — scale by A
                step_bytes = float(step_cost.get("bytes accessed", 0.0)) * A

                # with --with_image_tower, time BOTH variants in this one
                # process: the tower's marginal cost is only meaningful
                # in-process
                tower_variants = ([False, True] if tower_step is not None
                                  else [False])
                for use_tower in tower_variants:
                    def run_step(s, _tower=use_tower):
                        bd = batch_data
                        if _tower:
                            bd = dict(batch_data,
                                      image_embeddings=tower_step())
                        return step(s, bd, jax.random.key(5),
                                    jnp.float32(1e-4), jnp.float32(0.25),
                                    jnp.float32(0.5), text, med, med)

                    flops_per_window = step_flops + (
                        tower_flops if use_tower else 0.0)

                    # fresh copy per variant — the jitted step donates its
                    # state argument, so the original buffers die on use
                    sstate, _ = run_step(jax.tree.map(jnp.copy, state))
                    jax.block_until_ready(sstate)
                    n = max(args.iters // 4, 2)
                    dt = float("inf")
                    for _ in range(args.rounds):
                        t0 = time.perf_counter()
                        for _ in range(n):
                            sstate, info = run_step(sstate)
                        jax.block_until_ready(sstate)
                        dt = min(dt, (time.perf_counter() - t0) / n)

                    from rangeclip.utils.profiling import device_peaks

                    peak, hbm_peak = device_peaks(jax.devices()[0])
                    results.append({
                        "mode": "train_step",
                        "precision": "bf16" if bf16 else "fp32",
                        "pixel_sampler": sampler,
                        "image_tower": use_tower,
                        "accum": A, "microbatch": B, "resolution": res,
                        "s_per_step": round(dt, 4),
                        "maps_per_sec": round(A * B / dt, 2),
                        "gflop_per_map": round(
                            flops_per_window / (A * B) / 1e9, 2),
                        "tflops": round(flops_per_window / dt / 1e12, 2),
                        "pct_peak": round(
                            100 * flops_per_window / dt / peak, 1),
                        # analytic HLO operand+output bytes of the compiled
                        # step — an UPPER bound on memory traffic (on-chip
                        # reuse inside the scan body is not modeled, so
                        # small microbatches overcount; can exceed 100%)
                        "hlo_gb_per_step": round(step_bytes / 1e9, 2),
                        "hlo_bytes_vs_hbm_pct": round(
                            100 * step_bytes / dt / hbm_peak, 1),
                    })

    for r in results:
        print(json.dumps(r))


def cmd_robustness(args) -> None:
    import jax
    import jax.numpy as jnp

    from rangeclip.benchmark.robustness import (
        format_results_table,
        robustness_sweep,
    )
    from rangeclip.data.labels import (
        build_equivalence_class_map,
        build_equivalence_tensor,
        load_equivalence_dict,
    )
    from rangeclip.data.loader import setup_dataloaders
    from rangeclip.models.clip.provider import get_text_provider
    from rangeclip.models.depth_unet import (
        DepthUNet,
        DepthUNetConfig,
        build_candidate_mask,
    )
    from rangeclip.training.checkpoint import CheckpointManager

    _, val_loader, _, _, labels = setup_dataloaders(
        args.labeled_metadata_path, args.labels_path,
        (args.n_height, args.n_width), args.batch_size, n_epoch=1,
    )
    num_classes = len(labels)
    eq = build_equivalence_tensor(
        load_equivalence_dict(args.equivalence_dict_path), num_classes
    )
    eq_map = build_equivalence_class_map(eq)

    if args.subject == "clipseg":
        # The reference's actual benchmark subject (segclip.py:342-344):
        # HF CLIPSeg scoring per-sample GT+distractor prompts on the
        # perturbed RGB.  Reproduces BASELINE.md's published rows when the
        # CIDAS/clipseg-rd64-refined weights are available locally.
        from rangeclip.benchmark.clipseg import (
            hf_clipseg_logits_fn,
            make_clipseg_predict_fn,
        )

        predict_fn = make_clipseg_predict_fn(
            hf_clipseg_logits_fn(args.clipseg_path), labels,
            num_distractors=20,
        )
    else:
        if not args.checkpoint_dir:
            raise SystemExit("--subject depth requires --checkpoint_dir")
        # The text provider MUST match training: a real-CLIP-trained
        # checkpoint scored against the hash-stub embeddings produces
        # near-random rows that look like a valid sweep.
        text_provider = get_text_provider(
            args.clip_checkpoint_path, args.clip_vocab_path,
            args.clip_merges_path, dim=args.embedding_dim,
        )
        text_table = jnp.asarray(text_provider(labels), jnp.float32)

        cfg = DepthUNetConfig(use_batch_norm=True,
                              embedding_dim=args.embedding_dim)
        model = DepthUNet(cfg)
        # weights-only restore: independent of the training optimizer config
        params, batch_stats, _ = CheckpointManager(
            args.checkpoint_dir).restore_weights()
        variables = {"params": params, "batch_stats": batch_stats}

        @jax.jit
        def _predict(variables, depth, cand):
            return model.apply(variables, depth, text_table, cand, 5,
                               method=DepthUNet.predict)[0]

        def predict_fn(rng, batch, _enhanced_image):
            seg = jnp.asarray(batch["segmentation"])
            cand = build_candidate_mask(rng, seg, num_classes, 20)
            return _predict(variables, jnp.asarray(batch["depth"]), cand)

    results = robustness_sweep(
        lambda: val_loader, predict_fn, eq, eq_map, num_classes,
        brightness_levels=args.brightness_levels,
        saturation_levels=args.saturation_levels,
    )
    print(format_results_table(results))
    if args.plot_out:
        from rangeclip.benchmark.robustness import plot_results

        print(f"Plot: {plot_results(results, args.plot_out)}")


def cmd_loader(args) -> None:
    """Host data-pipeline throughput: decode + transform + batch, with and
    without the native C++ fast path."""
    import time as _time

    import numpy as np

    from rangeclip.data.loader import setup_dataloaders

    def run(tag):
        train_loader, _, _, _, _ = setup_dataloaders(
            args.labeled_metadata_path, args.labels_path,
            (args.n_height, args.n_width), args.batch_size, n_epoch=1,
        )
        train_loader.num_workers = args.num_workers
        n_maps = 0
        t0 = _time.perf_counter()
        for batch in train_loader:
            n_maps += int(batch["sample_valid"].sum())
        dt = _time.perf_counter() - t0
        print(json.dumps({
            "mode": "loader", "path": tag, "workers": args.num_workers,
            "resolution": f"{args.n_height}x{args.n_width}",
            "maps_per_sec": round(n_maps / dt, 2),
        }))

    import os as _os

    from rangeclip import native as native_mod

    if native_mod.lib() is not None:
        run("native-c++")
    # numpy fallback: the env toggle (unlike a monkeypatch) reaches the
    # loader's worker processes, which start from a forkserver helper.
    _os.environ["RANGECLIP_NATIVE"] = "off"
    try:
        run("numpy")
    finally:
        del _os.environ["RANGECLIP_NATIVE"]


def cmd_profile(args) -> None:
    import tempfile

    import jax
    import jax.numpy as jnp
    import numpy as np

    from rangeclip.models.depth_unet import (
        DepthUNet,
        DepthUNetConfig,
        build_candidate_indices,
        folded_is_profitable,
        predict_folded,
    )
    from rangeclip.utils.profiling import format_rows, summarize_trace

    res, C, D = args.resolution, args.num_classes, 512
    cfg = DepthUNetConfig(unet_type=args.unet_architecture,
                          use_batch_norm=True,
                          dtype=jnp.bfloat16 if args.bf16 else None)
    model = DepthUNet(cfg)

    if args.mode == "predict":
        B = args.batch_size or 128
        depth = jax.random.normal(jax.random.key(0), (B, res, res, 1),
                                  jnp.float32)
        variables = jax.jit(lambda k, d: model.init(k, d, train=False))(
            jax.random.key(1), depth
        )
        text = jax.random.normal(jax.random.key(2), (C, D), jnp.float32)
        seg = jax.random.randint(jax.random.key(3), (B, res, res), 0, 40)
        cand = build_candidate_indices(jax.random.key(4), seg, C, 300,
                                       capacity=384)
        folded = args.predict_path == "folded" or (
            args.predict_path == "auto" and folded_is_profitable(384, D)
        )

        @jax.jit
        def fn(variables, depth):
            if folded:
                out = predict_folded(model, variables, depth, text,
                                     top_k=5, candidate_indices=cand)
            else:
                out, _, _ = model.apply(
                    variables, depth, text, None, 5,
                    method=DepthUNet.predict, return_embeddings=False,
                    candidate_indices=cand,
                )
            return jnp.sum(out.reshape(-1).astype(jnp.float32))

        run = lambda: fn(variables, depth)
        hlo = fn.lower(variables, depth).compile().as_text()
    else:
        from rangeclip.losses.hybrid import HybridLossConfig
        from rangeclip.training.optim import make_optimizer
        from rangeclip.training.state import create_train_state
        from rangeclip.training.train_step import make_train_step

        A = args.accumulation_steps
        B = args.batch_size or 32
        opt = make_optimizer(1e-4)
        state = create_train_state(jax.random.key(0), cfg, opt,
                                   (B, res, res, 1))
        rng = np.random.default_rng(0)
        batch = {
            "depth": rng.standard_normal((A, B, res, res, 1)).astype(np.float32),
            "segmentation": rng.integers(0, 40, (A, B, res, res)).astype(np.int32),
            "object_label": np.ones((A, B), np.int32),
            "image_embeddings": rng.standard_normal((A, B, D)).astype(np.float32),
            "sample_valid": np.ones((A, B), np.float32),
        }
        text = jax.random.normal(jax.random.key(1), (C, D))
        med = jnp.zeros((C, C), bool)
        step = make_train_step(model, opt, HybridLossConfig(), accum_steps=A)

        def mk_run():
            holder = {"s": state}

            def run():
                holder["s"], info = step(
                    holder["s"], batch, jax.random.key(5),
                    jnp.float32(1e-4), jnp.float32(0.25), jnp.float32(0.5),
                    text, med, med,
                )
                return holder["s"]

            return run

        run = mk_run()
        hlo = None  # the step donates its state; lowering again is cheap
        hlo = step.lower(
            state, batch, jax.random.key(5), jnp.float32(1e-4),
            jnp.float32(0.25), jnp.float32(0.5), text, med, med,
        ).compile().as_text()

    jax.block_until_ready(run())  # compile + warm
    trace_dir = args.trace_dir or tempfile.mkdtemp(prefix="rangeclip_prof_")
    with jax.profiler.trace(trace_dir):
        out = None
        for _ in range(args.steps):
            out = run()
        jax.block_until_ready(out)
    rows = summarize_trace(trace_dir, steps=args.steps, hlo_text=hlo,
                           platform=jax.devices()[0].platform)
    print(format_rows(rows, top=args.top))
    print(f"# raw trace: {trace_dir}")


def main(argv=None) -> None:
    from rangeclip.utils.platform import enable_compilation_cache
    enable_compilation_cache()
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("throughput")
    t.add_argument("--resolution", type=int, default=256)
    t.add_argument("--unet_architecture", choices=["resnet", "mit"],
                   default="resnet",
                   help="Backbone: ResNet-18 UNet (flagship) or the "
                        "SegFormer-style MiT encoder (the 512^2 "
                        "streaming-inference stretch config).")
    t.add_argument("--batch_sizes", nargs="*", type=int, default=[1, 8, 32])
    t.add_argument("--train_configs", nargs="*", default=["8x4"],
                   metavar="AxB",
                   help="Gradient-accumulation train-step configs as "
                        "'<accum>x<microbatch>' (e.g. 8x4 1x32), A/B'd "
                        "within one process.  The reference's accum 8 fits "
                        "its GPU's memory; accum 1 x a bigger microbatch "
                        "does the same optimizer-step work with better "
                        "occupancy where memory allows (BN stats then span "
                        "the full batch — a documented change).")
    t.add_argument("--num_classes", type=int, default=512)
    t.add_argument("--predict_path", choices=("auto", "folded", "default"),
                   default="auto",
                   help="'folded' contracts the output conv with the text "
                   "table (bench.py's default); 'default' is the "
                   "reference-parity scoring order; 'auto' folds under "
                   "the measured ~1.5x-embedding-dim class-count crossover")
    t.add_argument("--iters", type=int, default=20)
    t.add_argument("--rounds", type=int, default=3)
    t.add_argument("--bf16", action="store_true")
    t.add_argument("--both_precisions", action="store_true")
    t.add_argument("--with_image_tower", action="store_true",
                   help="include the frozen CLIP ViT-B/32 image tower in "
                        "the timed train loop (one crop+tower call per "
                        "accumulation window, embeddings device-resident — "
                        "the trainer's real w_image>0 dispatch); random "
                        "weights, real shapes")
    t.add_argument("--pixel_sampler", nargs="+",
                   choices=["auto", "multinomial"], default=["auto"],
                   help="Pixel-draw counts for the train-step timing: "
                        "'auto' = histogram scatter (gather-bit-parity), "
                        "'multinomial' = scatter-free counts hoisted out "
                        "of the grad'd scan (same law, different stream). "
                        "Pass several to A/B them within one process.")
    t.set_defaults(fn=cmd_throughput)

    r = sub.add_parser("robustness")
    r.add_argument("--labeled_metadata_path", required=True)
    r.add_argument("--labels_path", required=True)
    r.add_argument("--equivalence_dict_path", required=True)
    r.add_argument("--subject", choices=["depth", "clipseg"], default="depth",
                   help="segmenter to sweep: the depth model from "
                        "--checkpoint_dir, or HF CLIPSeg (the reference's "
                        "RGB baseline, segclip.py:342-344)")
    r.add_argument("--checkpoint_dir", default=None,
                   help="required for --subject depth")
    r.add_argument("--clipseg_path", default="CIDAS/clipseg-rd64-refined",
                   help="local HF path for --subject clipseg")
    r.add_argument("--batch_size", type=int, default=8)
    r.add_argument("--n_height", type=int, default=224)
    r.add_argument("--n_width", type=int, default=224)
    r.add_argument("--embedding_dim", type=int, default=512)
    r.add_argument("--clip_checkpoint_path", default=None,
                   help="CLIP weights for the text provider — must match "
                   "what the checkpoint was trained against (stub when "
                   "omitted, like train/validate/infer)")
    r.add_argument("--clip_vocab_path", default=None)
    r.add_argument("--clip_merges_path", default=None)
    r.add_argument("--brightness_levels", nargs="+", type=float,
                   default=[1.0, 0.5, 0.2, 0.1, 0.05, 0.02, 0.01])
    r.add_argument("--saturation_levels", nargs="+", type=float, default=[1.0])
    r.add_argument("--plot_out", default=None,
                   help="write metric-vs-brightness curves to this PNG")
    r.set_defaults(fn=cmd_robustness)

    p = sub.add_parser(
        "profile",
        help="run N steps of the predict or train program under "
        "jax.profiler and print a per-op device-time table with XLA "
        "fusions mapped back to model ops (utils/profiling.py)",
    )
    p.add_argument("--mode", choices=("predict", "train"), default="predict")
    p.add_argument("--batch_size", type=int, default=None,
                   help="default: 128 for predict, 32 for train")
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--num_classes", type=int, default=512)
    p.add_argument("--accumulation_steps", type=int, default=1)
    p.add_argument("--unet_architecture", choices=["resnet", "mit"],
                   default="resnet")
    p.add_argument("--predict_path", choices=("auto", "folded", "default"),
                   default="auto")
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--fp32", dest="bf16", action="store_false")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--top", type=int, default=20)
    p.add_argument("--trace_dir", default=None,
                   help="keep the raw trace here (default: a temp dir)")
    p.set_defaults(fn=cmd_profile)

    l = sub.add_parser("loader")
    l.add_argument("--labeled_metadata_path", required=True)
    l.add_argument("--labels_path", required=True)
    l.add_argument("--batch_size", type=int, default=16)
    l.add_argument("--n_height", type=int, default=224)
    l.add_argument("--n_width", type=int, default=224)
    l.add_argument("--num_workers", type=int, default=4)
    l.set_defaults(fn=cmd_loader)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
