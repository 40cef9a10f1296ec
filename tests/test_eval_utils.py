"""Numpy eval helpers (utils/eval_utils.py) vs independent oracles —
reference semantics: raw-dot-product InfoNCE (no normalization, temp 0.1
default), RMSE/MAE, inverse-depth iRMSE/iMAE."""

import numpy as np

from rangeclip.utils.eval_utils import (
    info_nce_np,
    inv_mean_abs_err,
    inv_root_mean_sq_err,
    mean_abs_err,
    root_mean_sq_err,
)


def test_info_nce_matches_softmax_oracle():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((6, 8)).astype(np.float32)
    b = rng.standard_normal((6, 8)).astype(np.float32)

    # oracle: softmax over raw dot products / temperature, diagonal NLL
    sims = a @ b.T / 0.1
    probs = np.exp(sims) / np.exp(sims).sum(axis=1, keepdims=True)
    expected = float(np.mean(-np.log(np.diagonal(probs))))
    np.testing.assert_allclose(info_nce_np(a, b), expected, rtol=1e-5)

    # perfectly aligned identical rows at low temperature -> near-zero loss
    eye = np.eye(4, dtype=np.float32) * 10
    assert info_nce_np(eye, eye, temperature=0.1) < 1e-6

    # raw dot products, NOT cosine: scaling the inputs changes the loss
    assert abs(info_nce_np(a, b) - info_nce_np(2 * a, b)) > 1e-4


def test_depth_error_metrics():
    rng = np.random.default_rng(1)
    tgt = rng.uniform(1.0, 10.0, size=(50,)).astype(np.float32)
    src = tgt + rng.normal(0, 0.5, size=(50,)).astype(np.float32)

    np.testing.assert_allclose(
        root_mean_sq_err(src, tgt), np.sqrt(np.mean((tgt - src) ** 2)),
        rtol=1e-6)
    np.testing.assert_allclose(
        mean_abs_err(src, tgt), np.mean(np.abs(tgt - src)), rtol=1e-6)
    # inverse metrics are on 1/depth (reference eval_utils.py:64-77 — no
    # unit rescale)
    np.testing.assert_allclose(
        inv_root_mean_sq_err(src, tgt),
        np.sqrt(np.mean((1.0 / tgt - 1.0 / src) ** 2)), rtol=1e-6)
    np.testing.assert_allclose(
        inv_mean_abs_err(src, tgt),
        np.mean(np.abs(1.0 / tgt - 1.0 / src)), rtol=1e-6)

    assert root_mean_sq_err(tgt, tgt) == 0.0
    assert inv_root_mean_sq_err(tgt, tgt) == 0.0
