"""Baseline evaluators (evaluation.py parity): majority, random, SegFormer
probe harness."""

import numpy as np
import jax.numpy as jnp

from rangeclip.evals.baselines import (
    evaluate_majority_model,
    evaluate_random_model,
    evaluate_seg_former,
)

C = 8
B, H, W = 2, 8, 8


def _loader(n_batches=2, seed=0):
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(n_batches):
        seg = rng.integers(1, C, size=(B, H, W)).astype(np.int32)
        batches.append({
            "depth": rng.standard_normal((B, H, W, 1)).astype(np.float32),
            "image": rng.random((B, H, W, 3)).astype(np.float32),
            "segmentation": seg,
            "sample_valid": np.ones((B,), np.float32),
        })
    return batches


def _identity_equiv():
    return np.eye(C, dtype=bool)


def test_majority_baseline_perfect_on_constant_seg():
    batches = _loader()
    for b in batches:
        b["segmentation"][:] = 3
    res = evaluate_majority_model(
        batches, 3, _identity_equiv(), np.arange(C), C)
    assert res["pixel_accuracy_t1"] == 1.0


def test_random_baseline_bounded():
    res = evaluate_random_model(
        _loader(), C, _identity_equiv(), np.arange(C), num_negatives=C)
    assert 0.0 <= res["pixel_accuracy_t1"] <= 1.0


def test_seg_former_oracle_logits_scores_one():
    batches = _loader()

    def oracle(images):
        # perfect logits from the GT of the batch being evaluated
        seg = oracle.current_seg
        return np.eye(C, dtype=np.float32)[seg] * 10.0

    accs = []
    for b in batches:
        oracle.current_seg = b["segmentation"]
        accs.append(evaluate_seg_former(
            [b], oracle, C, equivalence_tensor=_identity_equiv(),
            num_negatives=C))
    assert all(a == 1.0 for a in accs)


def test_seg_former_low_res_logits_resized():
    batches = _loader(1)
    # blocky segmentation (4x4 tiles) so a half-resolution prediction
    # upsampled bilinearly still recovers nearly every pixel
    rng = np.random.default_rng(1)
    blocks = rng.integers(1, C, size=(B, H // 4, W // 4)).astype(np.int32)
    batches[0]["segmentation"] = np.kron(blocks, np.ones((4, 4), np.int32))
    seg = batches[0]["segmentation"]

    def half_res_oracle(images):
        small = seg[:, ::2, ::2]
        return np.eye(C, dtype=np.float32)[small] * 10.0

    acc = evaluate_seg_former(
        batches, half_res_oracle, C, equivalence_tensor=_identity_equiv(),
        num_negatives=C)
    # bilinear upsample of one-hot logits keeps most pixels correct
    assert acc > 0.5


def test_seg_former_ignores_padding_samples():
    """Duplicate padding samples (sample_valid=0, data/loader.py fixed-shape
    final batches) must not be counted in the SegFormer pixel accuracy."""
    batches = _loader(1)
    b = batches[0]
    # sample 0 will be predicted perfectly, sample 1 (a pad duplicate,
    # sample_valid=0) completely wrong — accuracy must still be 1.0
    b["sample_valid"] = np.array([1.0, 0.0], np.float32)

    def oracle(images):
        logits = np.eye(C, dtype=np.float32)[b["segmentation"]] * 10.0
        wrong = (b["segmentation"][1] % (C - 1)) + 1
        logits[1] = np.eye(C, dtype=np.float32)[wrong] * 10.0
        return logits

    acc = evaluate_seg_former(
        batches, oracle, C, equivalence_tensor=_identity_equiv(),
        num_negatives=C)
    assert acc == 1.0


def test_seg_former_equivalence_aware():
    batches = _loader(1)
    batches[0]["segmentation"][:] = 2

    def wrong_but_equivalent(images):
        return np.full((B, H, W, C), -1.0, np.float32) + \
            4.0 * np.eye(C, dtype=np.float32)[np.full((B, H, W), 5)]

    equiv = np.eye(C, dtype=bool)
    equiv[2, 5] = equiv[5, 2] = True  # class 5 counts as class 2
    acc = evaluate_seg_former(
        batches, wrong_but_equivalent, C, equivalence_tensor=equiv,
        num_negatives=C)
    assert acc == 1.0


def test_clipseg_adapter_reconstructs_segmentation():
    """The CLIPSeg subject (benchmark/clipseg.py) with an oracle logits_fn:
    per-prompt one-hot logits at the GT pixels must reconstruct the
    segmentation exactly through the prompt->global index mapping."""
    import jax

    from rangeclip.benchmark.clipseg import (
        clipseg_topk_from_logits,
        make_clipseg_predict_fn,
    )

    labels = [f"class_{i}" for i in range(C)]
    name_to_idx = {n: i for i, n in enumerate(labels)}
    batches = _loader(1)
    # blocky segmentation: half-res logits can then reconstruct it
    rng = np.random.default_rng(7)
    blocks = rng.integers(1, C, size=(B, H // 4, W // 4)).astype(np.int32)
    batches[0]["segmentation"] = np.kron(blocks, np.ones((4, 4), np.int32))
    seg = batches[0]["segmentation"]

    def oracle_logits_fn(prompts, image_hwc):
        # half resolution, like the real CLIPSeg's 352^2 internal grid
        h, w = H // 2, W // 2
        out = np.full((len(prompts), h, w), -5.0, np.float32)
        b = oracle_logits_fn.calls
        small = seg[b][::2, ::2]
        for p, name in enumerate(prompts):
            out[p][small == name_to_idx[name]] = 5.0
        oracle_logits_fn.calls += 1
        return out

    oracle_logits_fn.calls = 0
    predict_fn = make_clipseg_predict_fn(oracle_logits_fn, labels,
                                         num_distractors=2, top_k=3)
    pred = predict_fn(jax.random.key(0), batches[0], batches[0]["image"])
    assert pred.shape == (B, H, W, 3)
    assert (np.asarray(pred)[..., 0] == seg).mean() > 0.8  # bilinear edges

    # fewer prompts than top_k pads by repeating the last column
    one = clipseg_topk_from_logits(
        np.zeros((2, 4, 4), np.float32), [3, 6], (8, 8), top_k=5)
    assert one.shape == (8, 8, 5)
    assert set(np.asarray(one).ravel()) <= {3, 6}
