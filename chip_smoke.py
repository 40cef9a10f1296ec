"""Smoke test of the system on one NVIDIA GPU: the quickest proof that the
main path starts, runs and is right on the card.

    python chip_smoke.py            # phases 0-3 on one GPU
    python chip_smoke.py --four     # phase 4 only, on four GPUs of one host

Phases (one process; every phase must pass):
  0. device and environment: a GPU is required; prints the card's name and
     power limit, the JAX/jaxlib/CUDA-plugin versions and which optional
     packages import;
  1. predict at the bench configuration (flagship ResNet-18 DepthUNet,
     C=512, batch 128 @ 256^2, bf16, 384 candidate slots, top-5) through
     ``predict_folded`` and ``DepthUNet.predict``: compiled memory, peak
     device memory, a first-light maps/s, and the device time of the
     top-k selection from a profiler trace;
  2. training through ``rangeclip.cli.train``'s main on a synthetic
     dataset (flagship width, 1 x 32 @ 256^2, full hybrid loss, bf16, 4
     steps, checkpoints), then ``rangeclip.cli.infer``'s main on 2
     depth maps from that checkpoint;
  3. the card against the plain reference: the fp32 forward field against
     the CPU, bf16 labels against fp32 labels, and the hybrid loss terms
     and gradients against the CPU;
  4. (``--four``) the sync-BN data-parallel train step on a 4-device mesh
     against one device, and class-sharded predict (C=2048, model=4)
     against single-device predict.

The last line of stdout is ``{"ok": true, "device": {...}}`` and is
printed only when every phase passed; any failure exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Widths and shapes of every phase (FLAGSHIP on the card; tests run
    the same phases at TINY widths on the CPU)."""

    encoder_filters: Tuple[int, ...] = (32, 64, 128, 256, 512)
    embedding_dim: int = 512
    res: int = 256
    num_classes: int = 512
    capacity: int = 384
    negatives: int = 300
    top_k: int = 5
    predict_batch: int = 128
    timing_iters: int = 10
    train_batch: int = 32
    train_steps: int = 4
    n_samples: int = 56
    field_batch: int = 4
    label_batch: int = 8
    loss_batch: int = 32
    four_batch: int = 32
    four_classes: int = 2048


FLAGSHIP = Sizes()
TINY = Sizes(embedding_dim=32, res=32, num_classes=16, capacity=16,
             negatives=8, predict_batch=2, timing_iters=2, train_batch=2,
             n_samples=6, field_batch=2, label_batch=2, loss_batch=2,
             four_batch=4, four_classes=64)


# phase 4: each gradient leaf of the data-parallel step against the same
# leaf on one device is bounded by FOUR_GRAD_RTOL
# relative to that leaf's own largest entry, or FOUR_SPREAD_FACTOR times the
# spread that leaf shows on one device between two convolution algorithms,
# whichever is larger
FOUR_GRAD_RTOL = 1e-4
FOUR_SPREAD_FACTOR = 4.0


def log(msg: str) -> None:
    print(msg, flush=True)


def card_name_and_power_limit() -> str:
    """``name, power.limit`` as nvidia-smi reports it, from a child process
    that stays off JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({type(exc).__name__})"


def _config(sizes: Sizes, bf16: bool):
    import jax.numpy as jnp

    from rangeclip.models.depth_unet import DepthUNetConfig

    return DepthUNetConfig(encoder_filters=sizes.encoder_filters,
                           embedding_dim=sizes.embedding_dim,
                           use_batch_norm=True,
                           dtype=jnp.bfloat16 if bf16 else None)


def _close(name, got, want, rtol: float) -> str:
    """``|got - want| <= rtol * max|want|`` elementwise (a tolerance
    relative to the array's scale, so entries near zero are held to the
    same absolute bound as the rest); returns a report line."""
    import numpy as np

    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {want.shape}")
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    if not np.all(np.isfinite(got)) or err > rtol * max(scale, 1e-30):
        raise AssertionError(
            f"{name}: max |diff| {err:.3e} > {rtol} x max|ref| {scale:.3e}")
    return f"{name}: max |diff| {err:.3e} (max|ref| {scale:.3e})"


# ---------------------------------------------------------------------------
# Phase 0
# ---------------------------------------------------------------------------


def phase_device(require: str = "gpu") -> dict:
    import jax

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    if dev.platform != require:
        raise RuntimeError(f"JAX found no {require} (device 0 is {device})")
    return device


def phase_env() -> None:
    import importlib
    import importlib.metadata as md

    import jax

    log(f"card: {card_name_and_power_limit()}")
    versions = {"jax": jax.__version__}
    for dist in ("jaxlib", "jax-cuda12-plugin", "jax-cuda12-pjrt"):
        try:
            versions[dist] = md.version(dist)
        except md.PackageNotFoundError:
            versions[dist] = None
    log(f"versions: {json.dumps(versions)}")
    found = {}
    for mod in ("flax", "orbax.checkpoint", "pandas", "PIL"):
        try:
            importlib.import_module(mod)
            found[mod] = True
        except ImportError:
            found[mod] = False
    log(f"optional packages import: {json.dumps(found)}")


# ---------------------------------------------------------------------------
# Phase 1: predict at the bench configuration
# ---------------------------------------------------------------------------


def _topk_device_time(fn, args, calls: int, trace_dir: str, platform: str):
    """Per-call device time of the whole program and of its top-k ops,
    from a profiler trace of ``calls`` calls."""
    import jax
    from jax.profiler import ProfileData

    from rangeclip.utils.profiling import (
        busy_ns,
        latest_xplane,
        device_op_events,
        op_names_from_hlo,
    )

    compiled = fn.lower(*args).compile()
    names = op_names_from_hlo(compiled.as_text())
    with jax.profiler.trace(trace_dir):
        out = None
        for _ in range(calls):
            out = fn(*args)
        jax.block_until_ready(out)
    events = device_op_events(
        ProfileData.from_file(latest_xplane(trace_dir)), platform)
    total_ms = busy_ns(events) / calls / 1e6
    topk = [e for e in events
            if "top_k" in names.get(e[0], "") or "topk" in e[0].lower()]
    topk_ms = sum(d for _, _, d in topk) / calls / 1e6
    return total_ms, topk_ms, sorted({e[0] for e in topk})


def phase_predict(sizes: Sizes, trace_dir: str) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rangeclip.models.depth_unet import (
        DepthUNet,
        build_candidate_indices,
        predict_folded,
    )
    from rangeclip.utils.profiling import device_peaks

    dev = jax.devices()[0]
    model = DepthUNet(_config(sizes, bf16=True))
    B, R, C, K = sizes.predict_batch, sizes.res, sizes.num_classes, sizes.top_k
    depths = [jax.random.normal(jax.random.key(100 + i), (B, R, R, 1))
              for i in range(2)]
    variables = jax.jit(lambda k, d: model.init(k, d, train=False))(
        jax.random.key(1), depths[0])
    text = jax.random.normal(jax.random.key(2), (C, sizes.embedding_dim))
    seg = jax.random.randint(jax.random.key(3), (B, R, R), 0, 40)
    cand = build_candidate_indices(jax.random.key(4), seg, C,
                                   sizes.negatives, capacity=sizes.capacity)

    @jax.jit
    def folded(variables, depth):
        return predict_folded(model, variables, depth, text, top_k=K,
                              candidate_indices=cand)

    @jax.jit
    def default(variables, depth):
        return model.apply(variables, depth, text, None, K,
                           method=DepthUNet.predict, return_embeddings=False,
                           candidate_indices=cand)[0]

    card = card_name_and_power_limit()
    out = {}
    labels = {}
    for name, fn in (("predict_folded", folded), ("DepthUNet.predict", default)):
        t0 = time.perf_counter()
        compiled = fn.lower(variables, depths[0]).compile()
        log(f"[predict] {name}: compiled in {time.perf_counter() - t0:.1f} s; "
            f"memory_analysis: {compiled.memory_analysis()}")
        topk = np.asarray(jax.block_until_ready(compiled(variables, depths[0])))
        cand_np = np.asarray(cand)
        live = set(cand_np[cand_np >= 0].tolist())
        if topk.shape != (B, R, R, K) or topk.dtype != np.int32:
            raise AssertionError(f"{name}: output {topk.shape} {topk.dtype}")
        if not set(np.unique(topk).tolist()) <= live:
            raise AssertionError(f"{name}: labels outside the candidate set")
        labels[name] = topk[..., 0]
        t0 = time.perf_counter()
        for i in range(sizes.timing_iters):
            res = compiled(variables, depths[i % 2])
        jax.block_until_ready(res)
        dt = (time.perf_counter() - t0) / sizes.timing_iters
        out[name] = B / dt
        log(f"[predict] {name}: first light {B / dt:.1f} maps/s "
            f"({1e3 * dt:.2f} ms per batch of {B}, host clock around "
            f"block_until_ready; not a benchmark) on {card}")
    agree = float(np.mean(labels["predict_folded"]
                          == labels["DepthUNet.predict"]))
    log(f"[predict] top-1 agreement folded vs default (bf16): {agree:.5f}")
    if agree < 0.9:
        raise AssertionError(f"folded and default predict disagree: {agree}")
    stats = dev.memory_stats() or {}
    log(f"[predict] peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")

    total_ms, topk_ms, topk_ops = _topk_device_time(
        folded, (variables, depths[0]), 3, trace_dir, dev.platform)
    n_pix = B * (R // 2) * (R // 2)
    # top-k reads the bf16 [N, S] score field once, writes [N, k] ids+values
    topk_bytes = n_pix * sizes.capacity * 2 + n_pix * K * 8
    log(f"[predict] folded device time {total_ms:.3f} ms/call; top-k ops "
        f"{topk_ops}: {topk_ms:.3f} ms/call")
    if dev.platform == "gpu":
        _, peak_bw = device_peaks(dev)
        roof_ms = topk_bytes / peak_bw * 1e3
        log(f"[predict] top-k bytes roofline {roof_ms:.3f} ms "
            f"({topk_bytes / 1e9:.3f} GB at {peak_bw / 1e12:.2f} TB/s): "
            f"{100 * roof_ms / max(topk_ms, 1e-9):.1f}% of roofline, "
            f"{100 * topk_ms / max(total_ms, 1e-9):.1f}% of device time")
    out["topk_ms"] = topk_ms
    out["device_ms"] = total_ms
    return out


# ---------------------------------------------------------------------------
# Phase 2: train and infer through the CLIs
# ---------------------------------------------------------------------------


def phase_train(sizes: Sizes, workdir: str) -> dict:
    import numpy as np

    from rangeclip.cli import infer as infer_cli
    from rangeclip.cli import train as train_cli
    from rangeclip.data.synthetic import write_synthetic_dataset
    from rangeclip.training.checkpoint import CheckpointManager

    data = os.path.join(workdir, "data")
    paths = write_synthetic_dataset(data, n_samples=sizes.n_samples,
                                    shape=(sizes.res, sizes.res),
                                    num_classes=sizes.num_classes)
    run = os.path.join(workdir, "run")
    argv = [
        "--labeled_metadata_path", paths["metadata"],
        "--labels_path", paths["labels"],
        "--equivalence_dict_path", paths["similarity"],
        "--checkpoint_path", run,
        "--unet_architecture", "resnet",
        "--encoder_filters", *map(str, sizes.encoder_filters),
        "--embedding_dim", str(sizes.embedding_dim),
        "--batch_size", str(sizes.train_batch),
        "--n_height", str(sizes.res), "--n_width", str(sizes.res),
        "--accumulation_steps", "1", "--bf16",
        "--learning_rates", "1e-4", "--learning_schedule", "1000",
        "--max_steps", str(sizes.train_steps),
        "--n_step_per_checkpoint", "2", "--n_step_per_summary", "1",
        "--n_sample_per_summary", "0", "--validation_start_step", "1000000",
    ]
    t0 = time.perf_counter()
    train_cli.main(argv)
    log(f"[train] cli.train main: {sizes.train_steps} steps in "
        f"{time.perf_counter() - t0:.1f} s including compilation")

    with open(os.path.join(run, "results.txt")) as f:
        losses = [float(v) for v in re.findall(r"Loss=(\S+)", f.read())]
    if not losses or not all(np.isfinite(losses)):
        raise AssertionError(f"train losses not finite: {losses}")
    mgr = CheckpointManager(os.path.join(run, "checkpoints"))
    steps = mgr.steps()
    if steps[-1] != sizes.train_steps:
        raise AssertionError(f"checkpoint steps {steps}")
    early, _, _ = mgr.restore_weights(steps[0])
    late, _, _ = mgr.restore_weights(steps[-1])
    import jax

    moved = max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
                for a, b in zip(jax.tree.leaves(early), jax.tree.leaves(late)))
    if not moved > 0:
        raise AssertionError("params did not change between checkpoints")
    # wall time between the step-2 and final checkpoint files: two steps
    # with their data loading, logging and one checkpoint save
    t_early = os.path.getmtime(mgr._path(steps[0]))
    t_late = os.path.getmtime(mgr._path(steps[-1]))
    ms_step = 1e3 * (t_late - t_early) / (steps[-1] - steps[0])
    log(f"[train] losses {losses}; max |param change| step {steps[0]} -> "
        f"{steps[-1]}: {moved:.3e}; first light {ms_step:.1f} ms/step "
        f"(wall clock between checkpoints, incl. data loading and a "
        f"checkpoint save; not a benchmark) on {card_name_and_power_limit()}")

    out_dir = os.path.join(workdir, "infer")
    depth_glob = os.path.join(data, "depth_[01].png")
    infer_cli.main([
        "--checkpoint_dir", os.path.join(run, "checkpoints"),
        "--depth_glob", depth_glob, "--labels_path", paths["labels"],
        "--output_dir", out_dir, "--batch_size", "2",
        "--height", str(sizes.res), "--width", str(sizes.res),
        "--embedding_dim", str(sizes.embedding_dim), "--bf16",
    ])
    topks = sorted(glob.glob(os.path.join(out_dir, "*_topk.npy")))
    pngs = glob.glob(os.path.join(out_dir, "*_labels.png"))
    if len(topks) != 2 or len(pngs) != 2:
        raise AssertionError(f"infer outputs: {topks} {pngs}")
    for p in topks:
        t = np.load(p)
        if t.shape != (sizes.res, sizes.res, 5) or t.min() < 0 \
                or t.max() >= sizes.num_classes:
            raise AssertionError(f"{p}: shape {t.shape} range "
                                 f"[{t.min()}, {t.max()}]")
    log(f"[train] cli.infer main wrote {[os.path.basename(p) for p in topks]}")
    return {"losses": losses, "ms_per_step": ms_step}


# ---------------------------------------------------------------------------
# Phase 3: the card against the plain reference
# ---------------------------------------------------------------------------


def phase_reference(sizes: Sizes) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rangeclip.losses.hybrid import HybridLossConfig, compute_hybrid_loss
    from rangeclip.losses.infonce import (
        build_contrast_mask,
        sample_pixel_multiplicities,
    )
    from rangeclip.losses.pooling import (
        masked_average_pooling,
        per_item_masked_pooling,
    )
    from rangeclip.models.depth_unet import (
        DepthUNet,
        build_candidate_indices,
    )
    from rangeclip.utils.math import l2_normalize

    cpu = jax.devices("cpu")[0]
    on_cpu = lambda tree: jax.device_put(tree, cpu)  # noqa: E731
    R, D, C = sizes.res, sizes.embedding_dim, sizes.num_classes

    # (a) fp32 forward + L2-normalized field, device vs CPU
    model32 = DepthUNet(_config(sizes, bf16=False))
    depth = jax.random.normal(jax.random.key(11), (sizes.field_batch, R, R, 1))
    variables = jax.jit(lambda k, d: model32.init(k, d, train=False))(
        jax.random.key(12), depth)
    field_fn = jax.jit(lambda v, d: model32.apply(v, d)[0])
    with jax.default_matmul_precision("highest"):
        got = np.asarray(field_fn(variables, depth))
        want = np.asarray(field_fn(on_cpu(variables), on_cpu(depth)))
    err = float(np.max(np.abs(got - want)))
    log(f"[reference] fp32 field {got.shape}: max |device - cpu| {err:.3e}")
    if not err <= 1e-4:
        raise AssertionError(f"fp32 field differs from the CPU by {err}")

    # (b) bf16 labels against fp32 labels on the device
    B = sizes.label_batch
    depth = jax.random.normal(jax.random.key(13), (B, R, R, 1))
    text = jax.random.normal(jax.random.key(14), (C, D))
    seg = jax.random.randint(jax.random.key(15), (B, R, R), 0, 40)
    cand = build_candidate_indices(jax.random.key(16), seg, C,
                                   sizes.negatives, capacity=sizes.capacity)
    model16 = DepthUNet(_config(sizes, bf16=True))

    def labels(model):
        return jax.jit(lambda v, d: model.apply(
            v, d, text, None, 1, method=DepthUNet.predict,
            return_embeddings=False, candidate_indices=cand)[0][..., 0])

    @jax.jit
    def margins(v, d):
        field = model32.apply(v, d, method=DepthUNet.native_field)
        table = l2_normalize(text[jnp.maximum(cand, 0)], axis=-1)
        logits = jnp.einsum("bhwd,sd->bhws", field, table)
        logits = jnp.where(cand >= 0, logits, -1e30)
        top2 = jax.lax.top_k(logits, 2)[0]
        return top2[..., 0] - top2[..., 1]

    with jax.default_matmul_precision("highest"):
        lab32 = np.asarray(labels(model32)(variables, depth))[:, ::2, ::2]
        margin = np.asarray(margins(variables, depth))
    lab16 = np.asarray(labels(model16)(variables, depth))[:, ::2, ::2]
    agree = float(np.mean(lab16 == lab32))
    clear = margin >= 1e-2
    n_bad = int(np.sum((lab16 != lab32) & clear))
    log(f"[reference] bf16 vs fp32 top-1: agreement {agree:.5f}; "
        f"{int(clear.sum())} pixels with margin >= 1e-2, {n_bad} disagree")
    if agree < 0.99 or n_bad:
        raise AssertionError("bf16 labels drift from the fp32 labels")

    # (c) hybrid loss terms and gradients, device vs CPU, fp32 highest
    B, h = sizes.loss_batch, R // 2
    ks = jax.random.split(jax.random.key(17), 8)
    field = l2_normalize(jax.random.normal(ks[0], (B, h, h, D)), axis=-1)
    seg = jax.random.randint(ks[1], (B, R, R), 0, min(C, 40))
    table = jax.random.normal(ks[2], (C, D))
    med = jax.random.bernoulli(ks[3], 0.02, (C, C))
    hard = jax.random.bernoulli(ks[4], 0.02, (C, C))
    area = jax.random.normal(ks[5], (B, D))
    image = jax.random.normal(ks[6], (B, D))
    obj = jnp.arange(1, min(C, 40), dtype=jnp.int32)

    def terms(field, area, seg, rng):
        def loss(field, area):
            total, info = compute_hybrid_loss(
                rng, field, seg, table, med, hard, jnp.float32(0.07),
                jnp.float32(0.1), 0.25, 0.5, area_embeddings=area,
                image_embeddings=image, config=HybridLossConfig(),
                label_upsample=2)
            return total, info

        (total, info), (g_field, g_area) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(field, area)
        labels_ = seg[:, 0, 0]
        pooled, pool_vjp = jax.vjp(
            lambda f: per_item_masked_pooling(f, seg, labels_, upsample=2),
            field)
        weights, flat_labels = sample_pixel_multiplicities(rng, seg, 0.7)
        return {
            "total": total,
            "text_ce": info["text_contrastive_loss"],
            "area_image_ce": info["image_contrastive_loss"],
            "tv": info["smoothness_loss"],
            "grad_field": g_field, "grad_area": g_area,
            "per_item_pooling": pooled,
            "per_item_pooling_vjp": pool_vjp(jnp.ones_like(pooled))[0],
            "batch_pooling": masked_average_pooling(
                field[:, :, :, :], seg[:, ::2, ::2], obj),
            "histogram": weights,
            "presence_mask": build_contrast_mask(
                rng, flat_labels, weights, C, med, hard, 50, 0.25, 0.5),
        }

    fn = jax.jit(terms)
    rng = jax.random.key(18)
    with jax.default_matmul_precision("highest"):
        got = jax.device_get(fn(field, area, seg, rng))
        want = jax.device_get(fn(*on_cpu((field, area, seg, rng))))
    for name in ("histogram", "presence_mask"):
        if not np.array_equal(got[name], want[name]):
            raise AssertionError(f"{name} differs between device and CPU")
        log(f"[reference] {name}: identical")
    for name in sorted(set(got) - {"histogram", "presence_mask"}):
        log("[reference] " + _close(name, got[name], want[name], 1e-4))


# ---------------------------------------------------------------------------
# Phase 4 (--four): the multi-device paths
# ---------------------------------------------------------------------------


def four_train_grads(sizes: Sizes, batch: int, mesh=None,
                     compiler_options=None):
    """Gradients and loss info of one fp32 sync-BN train step at ``sizes``'
    widths on a ``batch``-sized global batch made from a fixed seed: on
    ``mesh`` (batch sharded over 'data', state replicated) when given, else
    on the default device (compiled with XLA ``compiler_options`` when
    given).  Returns host copies of (grads, info)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from rangeclip.losses.hybrid import HybridLossConfig
    from rangeclip.models.depth_unet import DepthUNet
    from rangeclip.parallel.mesh import replicate, shard_batch
    from rangeclip.training.state import create_train_state
    from rangeclip.training.train_step import make_train_step

    cfg = _config(sizes, bf16=False)
    R, D, C, B = sizes.res, sizes.embedding_dim, sizes.num_classes, batch
    # An optimizer whose state IS the last gradient: the train step's own
    # gradients come back exactly, and the parameters stay put.
    keep_grads = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    rng = np.random.default_rng(21)
    n_labels = min(C, 40)
    data = {
        "depth": rng.standard_normal((1, B, R, R, 1)).astype(np.float32),
        "segmentation": rng.integers(0, n_labels, (1, B, R, R)).astype(
            np.int32),
        "object_label": rng.integers(1, n_labels, (1, B)).astype(np.int32),
        "image_embeddings": rng.standard_normal((1, B, D)).astype(np.float32),
        "sample_valid": np.ones((1, B), np.float32),
    }
    text = rng.standard_normal((C, D)).astype(np.float32)
    med = np.zeros((C, C), bool)
    args = (jax.random.key(22), jnp.float32(1.0), jnp.float32(0.25),
            jnp.float32(0.5))
    state = create_train_state(jax.random.key(23), cfg, keep_grads,
                               (B, R, R, 1))
    step = make_train_step(DepthUNet(cfg), keep_grads, HybridLossConfig(),
                           accum_steps=1, mesh=mesh)
    tables = (text, med, med)
    if mesh is not None:
        n = mesh.devices.size
        state = replicate(mesh, state)
        data = shard_batch(mesh, data, batch_axis=1)
        tables = replicate(mesh, tables)
        for k, v in data.items():
            if len(v.sharding.device_set) != n:
                raise AssertionError(f"batch {k} is not on all {n} devices")
    with jax.default_matmul_precision("highest"):
        if compiler_options:
            step = step.lower(state, data, *args, *tables).compile(
                compiler_options)
        new_state, info = step(state, data, *args, *tables)
    jax.block_until_ready(new_state)
    if mesh is not None:
        for leaf in jax.tree.leaves((new_state, info)):
            if len(leaf.sharding.device_set) != n:
                raise AssertionError("a train-step output lives on "
                                     f"{leaf.sharding.device_set} only")
    return jax.device_get((new_state.opt_state, info))


def leaf_errors(got, want):
    """``(max|got - want| / max|want|, max|want|, path)`` for every leaf of
    two gradient trees, worst first."""
    import jax
    import numpy as np

    rows = []
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        w = np.asarray(w, np.float64)
        scale = float(np.max(np.abs(w)))
        err = float(np.max(np.abs(np.asarray(g, np.float64) - w)))
        rows.append((err / max(scale, 1e-30), scale,
                     jax.tree_util.keystr(path)))
    return sorted(rows, reverse=True)


def tie_groups(scores, dim: int):
    """Label each rank of a pixel's descending ``scores`` [..., k] with its
    near-tie group: consecutive ranks whose computed gap is under the
    rounding bound of a unit-vector dot product share a group.

    A score is a dot product of two unit vectors of length D, so each
    computation of it is within gamma_D = D u / (1 - D u) of the exact
    value (u = 2^-24); two computations that sum in different orders can
    swap two scores only where their computed gap is under 4 gamma_D.
    Returns (groups [..., k] int, bound)."""
    import numpy as np

    u = 2.0 ** -24
    bound = 4 * dim * u / (1 - dim * u)
    gap = -np.diff(scores, axis=-1)
    new_group = np.concatenate(
        [np.ones(scores.shape[:-1] + (1,), bool), gap >= bound], axis=-1)
    return np.cumsum(new_group, axis=-1), bound


def excused_flips(got, want, ref_ids, groups):
    """Pixels where ``got`` differs from ``want`` at a rank whose two labels
    are not both members of that rank's near-tie group of the reference
    ranking ``ref_ids`` (the reference's top-(k+1), so a last-rank label
    may be swapped with the first one left out).  All inputs [..., k] /
    [..., k+1]; returns a bool mask of pixels with an unexcused flip."""
    import numpy as np

    k = got.shape[-1]
    bad = np.zeros(got.shape[:-1], bool)
    for r in range(k):
        members = groups == groups[..., r:r + 1]
        in_g = lambda lab: np.any(  # noqa: E731
            members & (ref_ids == lab[..., None]), axis=-1)
        diff = got[..., r] != want[..., r]
        bad |= diff & ~(in_g(got[..., r]) & in_g(want[..., r]))
    return bad


def phase_four(sizes: Sizes, n: int = 4) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rangeclip.models.depth_unet import DepthUNet
    from rangeclip.parallel.mesh import make_mesh
    from rangeclip.parallel.predict import (
        _local_default_topk,
        make_sharded_predict,
        pad_class_table,
        shard_predict_inputs,
    )
    from rangeclip.utils.math import l2_normalize

    devices = jax.devices()[:n]
    if len(devices) < n:
        raise RuntimeError(f"--four needs {n} devices, found {len(devices)}")
    model = DepthUNet(_config(sizes, bf16=False))
    R, D, K = sizes.res, sizes.embedding_dim, sizes.top_k

    B = sizes.four_batch
    grads_1, info_1 = four_train_grads(sizes, B)
    # The same step on one device with XLA's default convolution algorithms
    # in place of autotuned ones: two summation orders of the same math.
    # Their per-leaf spread is the rounding residue each leaf carries; a
    # gradient leaf of a conv in front of a BatchNorm is a small difference
    # of large terms and carries much more than 1e-4 of its own scale.
    grads_alt, _ = four_train_grads(
        sizes, B, compiler_options={"xla_gpu_autotune_level": 0})
    grads_n, info_n = four_train_grads(
        sizes, B, make_mesh(n_data=n, devices=devices))
    log("[four] " + _close("loss", info_n["total_loss"],
                           info_1["total_loss"], 1e-4))
    log("[four] " + _close(
        "gradient as one vector",
        np.concatenate([np.ravel(g) for g in jax.tree.leaves(grads_n)]),
        np.concatenate([np.ravel(g) for g in jax.tree.leaves(grads_1)]),
        1e-4))
    spread = {path: r for r, _, path in leaf_errors(grads_alt, grads_1)}
    rows = [(r / max(FOUR_GRAD_RTOL, FOUR_SPREAD_FACTOR * spread[path]), r,
             spread[path], scale, path)
            for r, scale, path in leaf_errors(grads_n, grads_1)]
    rows.sort(reverse=True)
    log(f"[four] one device, autotuned vs XLA default conv algorithms: "
        f"{sum(s > FOUR_GRAD_RTOL for s in spread.values())} of {len(spread)}"
        f" leaves differ by more than {FOUR_GRAD_RTOL:g} of their own scale,"
        f" worst {max(spread.values()):.2e}")
    for used, r, s, scale, path in rows[:3]:
        log(f"[four] gradient leaf {path}: data={n} vs one device {r:.2e} of "
            f"its scale {scale:.3e}; algorithm spread {s:.2e}; "
            f"{used:.2f} of its bound")
    over = [row for row in rows if row[0] > 1]
    log(f"[four] sync-BN data-parallel gradients on data={n} vs one device: "
        f"{len(rows) - len(over)} of {len(rows)} leaves within max("
        f"{FOUR_GRAD_RTOL:g}, {FOUR_SPREAD_FACTOR:g} x algorithm spread) of "
        f"their own scale")
    if over:
        raise AssertionError(f"{len(over)} gradient leaves exceed their "
                             f"bound: {over[:3]}")

    # class-sharded predict, C=four_classes over model=n, fp32 highest
    Cb = sizes.four_classes
    depth = jax.random.normal(jax.random.key(24), (sizes.label_batch, R, R, 1))
    variables = jax.jit(lambda k, d: model.init(k, d, train=False))(
        jax.random.key(25), depth)
    table = jax.random.normal(jax.random.key(26), (Cb, D))
    mesh = make_mesh(n_data=1, n_model=n, devices=devices)
    padded, ids = pad_class_table(table, n)
    fn = make_sharded_predict(model, mesh, top_k=K, predict_path="default")
    per = padded.shape[0] // n
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda v, d: model.apply(
            v, d, table, jnp.ones((Cb,), bool), K,
            method=DepthUNet.predict, return_embeddings=False)[0])(
                variables, depth))[:, ::2, ::2]
        with jax.sharding.set_mesh(mesh):
            d_in, t_in, i_in = shard_predict_inputs(mesh, depth, padded, ids)
            for name, x in (("table", t_in), ("ids", i_in)):
                if len(x.sharding.device_set) != n:
                    raise AssertionError(
                        f"{name} is not sharded over {n} devices")
            got = np.asarray(fn(variables, d_in, t_in, i_in))[:, ::2, ::2]
        # witnesses without any sharding: the sharded path's own scoring on
        # one device, over the whole table and over its n class slices
        # merged as the shards merge them
        local = jax.jit(lambda v, d, t, i: _local_default_topk(
            model, v, d, t, i, K))
        whole = np.asarray(local(variables, depth, padded, ids)[0])
        parts = [local(variables, depth, padded[s * per:(s + 1) * per],
                       ids[s * per:(s + 1) * per]) for s in range(n)]
        idx = jnp.concatenate([p[0] for p in parts], axis=-1)
        val = jnp.concatenate([p[1] for p in parts], axis=-1)
        slices = np.asarray(jax.lax.sort(
            (-val, idx), dimension=-1, num_keys=2)[1][..., :K])
        ref_val, ref_ids = jax.jit(lambda v, d: jax.lax.top_k(jnp.einsum(
            "bhwd,cd->bhwc",
            model.apply(v, d, method=DepthUNet.native_field),
            l2_normalize(table, axis=-1)), K + 1))(variables, depth)
    groups, bound = tie_groups(np.asarray(ref_val), D)
    ref_ids = np.asarray(ref_ids)
    differ = np.any(got != want, axis=-1)
    bad = excused_flips(got, want, ref_ids, groups)
    log(f"[four] class-sharded predict C={Cb} over model={n} vs "
        f"single-device DepthUNet.predict: {int(differ.sum())} of "
        f"{differ.size} native pixels differ, {int(bad.sum())} of them at a "
        f"rank whose labels are not in one near-tie group (consecutive "
        f"scores within {bound:.2e}); {int(np.sum(groups[..., -1] < K + 1))}"
        f" pixels hold a near-tie in their top {K + 1}")
    for name, x in (("whole table", whole), (f"{n} class slices", slices)):
        d = np.any(x != want, axis=-1)
        log(f"[four] witness, one device, no sharding, {name}: "
            f"{int(d.sum())} pixels differ from DepthUNet.predict "
            f"({int(np.sum(d & differ))} of them where the sharded labels "
            f"differ too); {int(excused_flips(x, want, ref_ids, groups).sum())}"
            f" outside a near-tie; identical to the sharded labels: "
            f"{bool(np.array_equal(x, got))}")
    if np.any(bad):
        raise AssertionError("class-sharded labels differ from one device "
                             "where the ranking is not a near-tie")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the four-GPU phase")
    parser.add_argument("--out", default=None,
                        help="directory for the profiler trace and scratch "
                        "files (default: a temporary directory, removed)")
    args = parser.parse_args(argv)

    failed = []
    try:
        device = phase_device("gpu")
    except Exception:  # noqa: BLE001 — no accelerator: no result
        traceback.print_exc()
        return 1
    log(f"device: {json.dumps(device)}")

    workdir = args.out or tempfile.mkdtemp(prefix="chip_smoke_")
    os.makedirs(workdir, exist_ok=True)

    def phase(name, fn, *fn_args):
        t0 = time.perf_counter()
        log(f"=== phase {name}")
        try:
            fn(*fn_args)
            log(f"=== phase {name}: ok ({time.perf_counter() - t0:.1f} s)")
        except Exception:  # noqa: BLE001 — every failure is reported
            traceback.print_exc()
            log(f"=== phase {name}: FAILED ({time.perf_counter() - t0:.1f} s)")
            failed.append(name)

    try:
        from rangeclip.utils.platform import enable_compilation_cache

        enable_compilation_cache()
        if args.four:
            if device["count"] < 4:
                log(f"--four needs 4 devices, found {device['count']}")
                return 1
            phase("4 four-device", phase_four, FLAGSHIP)
        else:
            phase("0 environment", phase_env)
            phase("1 predict", phase_predict, FLAGSHIP,
                  os.path.join(workdir, "trace"))
            phase("2 train", phase_train, FLAGSHIP,
                  os.path.join(workdir, "train"))
            phase("3 reference", phase_reference, FLAGSHIP)
    except Exception:  # noqa: BLE001
        traceback.print_exc()
        failed.append("setup")
    finally:
        if args.out is None:
            shutil.rmtree(workdir, ignore_errors=True)

    if failed:
        log(f"FAILED phases: {failed}")
        return 1
    log(f"card: {card_name_and_power_limit()}")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
