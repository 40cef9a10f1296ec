"""Throughput benchmark — depth maps/sec on one device at 256x256
segmentation inference (the BASELINE.json north-star metric).

Measures the full flagship inference path: ResNet-18 DepthUNet forward
(512-dim CLIP space, bf16 compute) + pixel x text scoring against a
384-slot reduced candidate table (a 512-class label table, 300 sampled
negatives) + top-5 labels at 256^2, i.e. the reference's predict
(model.py:119-175).  Scoring runs at the decoder's native H/2 resolution
with the top-k indices nearest-upsampled — proven exactly equal to
full-resolution scoring
(tests/test_model_and_train.py::test_predict_native_scoring_identity).

Default path: the FOLDED head (models/depth_unet.py predict_folded) — the
bias-free output conv is contracted with the normalized candidate table so
the conv scores candidates directly ([B,h,w,384] instead of a [B,h,w,512]
embedding field plus a scoring matmul; identical ranking, proven in
tests), then ``lax.top_k`` selects the labels.  BENCH_PREDICT=default
times the unfolded predict path (bf16 near-ties round differently between
the two, so their checksums differ; each is deterministic).

Integrity:
  * every call's top-k output is reduced to a device-side scalar checksum,
    and each timing round ends in ``jax.block_until_ready``;
  * checksums must be bit-identical across rounds (same inputs), else fail;
  * the program's convolution and matmul FLOPs, counted from its jaxpr
    (``utils.roofline.jaxpr_matmul_flops``; XLA's ``cost_analysis`` does not
    count the cuDNN convolutions on the GPU), bound the result: if the
    implied FLOP/s exceeds the device's published peak the benchmark
    aborts instead of printing fiction;
  * it refuses to run without an accelerator.

Prints the device (platform, kind, count) and the card's name and power
limit on stderr, then ONE JSON line on stdout: {"metric", "value", "unit",
"vs_baseline", "device", ...}.

vs_baseline: the reference publishes no throughput numbers (BASELINE.md).
The denominator is an engineering estimate of the reference PyTorch
predict on its development GPU (documented in BASELINE.md), ~300 maps/s.
Treat vs_baseline as indicative until a measured baseline lands.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REF_BASELINE_MAPS_PER_SEC = 300.0

BATCH = int(os.environ.get("BENCH_BATCH", 128))
RES = 256
NUM_CLASSES = 512
TOP_K = 5
WARMUP = 3
ITERS = int(os.environ.get("BENCH_ITERS", 30))
ROUNDS = int(os.environ.get("BENCH_ROUNDS", 4))


def _progress(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def card_name_and_power_limit() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({type(exc).__name__})"


def main() -> None:
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        raise SystemExit("bench.py measures an accelerator; JAX found none")

    from rangeclip.models.depth_unet import (
        DepthUNet,
        DepthUNetConfig,
        build_candidate_indices,
        predict_folded,
    )
    from rangeclip.utils.platform import enable_compilation_cache
    from rangeclip.utils.profiling import device_peaks
    from rangeclip.utils.roofline import jaxpr_matmul_flops

    enable_compilation_cache()
    peak_flops, _ = device_peaks(dev)
    card = card_name_and_power_limit()
    folded = os.environ.get("BENCH_PREDICT", "folded") == "folded"

    cfg = DepthUNetConfig(use_batch_norm=True, dtype=jnp.bfloat16)
    model = DepthUNet(cfg)

    # Distinct input buffers are cycled during timing so the measurement
    # can never be satisfied by any caching layer.
    depths = [
        jax.random.normal(jax.random.key(100 + i), (BATCH, RES, RES, 1),
                          jnp.float32)
        for i in range(8)
    ]
    variables = jax.jit(lambda k, d: model.init(k, d, train=False))(
        jax.random.key(1), depths[0]
    )
    text = jax.random.normal(jax.random.key(2), (NUM_CLASSES, 512), jnp.float32)
    seg = jax.random.randint(jax.random.key(3), (BATCH, RES, RES), 0, 40)
    # Gathered reduced-candidate form (the reference's own predict
    # formulation, model.py:147-161): capacity 384 bounds the 40-label GT
    # plus 300 negatives.
    cand = build_candidate_indices(jax.random.key(4), seg, NUM_CLASSES, 300,
                                   capacity=384)

    @jax.jit
    def predict(variables, depth, text, cand):
        if folded:
            topk = predict_folded(model, variables, depth, text, top_k=TOP_K,
                                  candidate_indices=cand)
        else:
            topk, _, _ = model.apply(
                variables, depth, text, None, TOP_K,
                method=DepthUNet.predict, return_embeddings=False,
                candidate_indices=cand,
            )
        # scalar checksum over the full [B, H, W, k] label field
        return jnp.sum(topk.reshape(-1).astype(jnp.float32))

    compiled = predict.lower(variables, depths[0], text, cand).compile()
    flops_per_call = float(jaxpr_matmul_flops(
        jax.make_jaxpr(predict)(variables, depths[0], text, cand)))
    _progress(
        f"predict: {flops_per_call / 1e9:.1f} GFLOP/call of convolutions "
        f"and matmuls ({flops_per_call / BATCH / 1e9:.2f} GFLOP/map), "
        f"device peak {peak_flops / 1e12:.0f} TFLOP/s"
    )

    def run_round() -> float:
        acc = None
        for i in range(ITERS):
            c = compiled(variables, depths[i % len(depths)], text, cand)
            acc = c if acc is None else acc + c
        return float(jax.block_until_ready(acc))

    chk0 = run_round()
    if chk0 != chk0:  # NaN guard
        raise SystemExit("benchmark checksum is NaN — model output is garbage")
    for _ in range(1, WARMUP):
        run_round()

    best_dt = float("inf")
    checksums = []
    for r in range(ROUNDS):
        t0 = time.perf_counter()
        total = run_round()
        dt = time.perf_counter() - t0
        checksums.append(total)
        best_dt = min(best_dt, dt)
        _progress(f"round {r}: {BATCH * ITERS / dt:.0f} maps/s, "
                  f"checksum {total:.0f}")

    if len(set(checksums)) != 1:
        raise SystemExit(f"non-deterministic checksums across rounds: {checksums}")

    maps_per_sec = BATCH * ITERS / best_dt
    implied_flops = flops_per_call * ITERS / best_dt
    if implied_flops > peak_flops:
        raise SystemExit(
            f"implied {implied_flops / 1e12:.0f} TFLOP/s exceeds the device "
            f"peak {peak_flops / 1e12:.0f} TFLOP/s — the measurement did not "
            "capture real execution; refusing to report it"
        )
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    _progress(f"device {device}; card {card}")
    _progress(
        f"best: {maps_per_sec:.0f} maps/s, implied "
        f"{implied_flops / 1e12:.2f} TFLOP/s "
        f"({100 * implied_flops / peak_flops:.1f}% of the bf16 peak)"
    )
    print(json.dumps({
        "metric": "depth maps/sec @ 256^2 seg inference (fwd+score+top5)",
        "value": round(maps_per_sec, 2),
        "unit": "maps/s",
        "vs_baseline": round(maps_per_sec / REF_BASELINE_MAPS_PER_SEC, 3),
        "baseline_note": "denominator 300 maps/s is an estimated "
                         "reference-GPU figure (BASELINE.md)",
        "device": device,
        "card": card,
        "batch": BATCH,
        "predict_path": "folded" if folded else "default",
    }))


if __name__ == "__main__":
    main()
