"""Equivalence-aware metrics vs a reference-style python-loop oracle
(replicating validate.py:95-139 semantics, including the raw-top1 oracle
quirk)."""

from collections import defaultdict

import numpy as np
import jax.numpy as jnp

from rangeclip.evals.metrics import metrics_finalize, metrics_init, metrics_update


def _oracle(pred_topk, gt, equiv, cmap):
    """Direct transcription of the documented reference metric semantics."""
    B, H, W, k = pred_topk.shape
    gt_flat = gt.reshape(-1)
    topk_flat = pred_topk.reshape(-1, k)
    top1 = topk_flat[:, 0]

    correct1 = equiv[gt_flat, top1].sum()
    correctk = equiv[gt_flat[:, None], topk_flat].any(1).sum()
    total = gt_flat.size

    gt_e = cmap[gt_flat]
    p1_e = cmap[top1]
    inter1, union1 = defaultdict(int), defaultdict(int)
    for label in np.unique(np.concatenate([gt_e, p1_e])):
        pm, gm = p1_e == label, gt_e == label
        inter1[label] += int((pm & gm).sum())
        union1[label] += int((pm | gm).sum())

    topk_e = cmap[topk_flat]
    oracle_pred = top1.copy()
    for label in np.unique(np.concatenate([gt_e, p1_e])):
        match = (gt_e == label) & (topk_e == label).any(1)
        oracle_pred[match] = label
    interk, unionk = defaultdict(int), defaultdict(int)
    for label in np.unique(np.concatenate([gt_e, p1_e])):
        pm, gm = oracle_pred == label, gt_e == label
        interk[label] += int((pm & gm).sum())
        unionk[label] += int((pm | gm).sum())

    valid = set(gt_e.tolist())

    def miou(inter, union):
        ious = [inter[l] / union[l] for l in union if union[l] > 0 and l in valid]
        return sum(ious) / len(ious) if ious else 0.0

    return {
        "pixel_accuracy_t1": correct1 / total,
        "pixel_accuracy_tk": correctk / total,
        "mIoU_t1": miou(inter1, union1),
        "mIoU_tk": miou(interk, unionk),
    }


def test_metrics_match_reference_oracle():
    rng = np.random.default_rng(0)
    B, H, W, k, C = 2, 12, 12, 3, 15
    gt = rng.integers(0, C, size=(B, H, W))
    pred = rng.integers(0, C, size=(B, H, W, k))

    equiv = np.eye(C, dtype=bool)
    # classes 3,4 equivalent; 7,8,9 equivalent
    for a in (3, 4):
        for b in (3, 4):
            equiv[a, b] = True
    for a in (7, 8, 9):
        for b in (7, 8, 9):
            equiv[a, b] = True
    cmap = np.arange(C)
    cmap[4] = 3
    cmap[8] = cmap[9] = 7

    acc = metrics_init(C)
    acc = metrics_update(acc, jnp.asarray(pred), jnp.asarray(gt),
                         jnp.asarray(equiv), jnp.asarray(cmap))
    got = metrics_finalize(acc)
    want = _oracle(pred, gt, equiv, cmap)

    for key, val in want.items():
        np.testing.assert_allclose(got[key], val, rtol=1e-6, err_msg=key)


def test_metrics_batch_accumulation_and_weights():
    rng = np.random.default_rng(1)
    C = 8
    equiv = np.eye(C, dtype=bool)
    cmap = np.arange(C)

    gt = rng.integers(0, C, size=(4, 6, 6))
    pred = rng.integers(0, C, size=(4, 6, 6, 2))

    # two batches of 2 == one batch of 4
    acc1 = metrics_init(C)
    acc1 = metrics_update(acc1, jnp.asarray(pred), jnp.asarray(gt),
                          jnp.asarray(equiv), jnp.asarray(cmap))
    acc2 = metrics_init(C)
    for s in (slice(0, 2), slice(2, 4)):
        acc2 = metrics_update(acc2, jnp.asarray(pred[s]), jnp.asarray(gt[s]),
                              jnp.asarray(equiv), jnp.asarray(cmap))
    r1, r2 = metrics_finalize(acc1), metrics_finalize(acc2)
    for key in ("pixel_accuracy_t1", "mIoU_t1", "mIoU_tk"):
        np.testing.assert_allclose(r1[key], r2[key], rtol=1e-6)

    # zero-weighted samples drop out entirely
    w = np.array([1, 1, 0, 0], np.float32)
    acc3 = metrics_init(C)
    acc3 = metrics_update(acc3, jnp.asarray(pred), jnp.asarray(gt),
                          jnp.asarray(equiv), jnp.asarray(cmap),
                          pixel_weight=jnp.asarray(w))
    acc4 = metrics_init(C)
    acc4 = metrics_update(acc4, jnp.asarray(pred[:2]), jnp.asarray(gt[:2]),
                          jnp.asarray(equiv), jnp.asarray(cmap))
    r3, r4 = metrics_finalize(acc3), metrics_finalize(acc4)
    for key in ("pixel_accuracy_t1", "pixel_accuracy_tk", "mIoU_t1", "mIoU_tk"):
        np.testing.assert_allclose(r3[key], r4[key], rtol=1e-6)
