"""Evaluation layer (L5): equivalence-aware metrics, validation harness,
reference baselines."""

from rangeclip.evals.metrics import (
    metrics_init,
    metrics_update,
    metrics_finalize,
)

__all__ = ["metrics_init", "metrics_update", "metrics_finalize"]
